"""Configurations the JAX package trains that the card now runs, and the
port's float32 precision policy.

* the transformer AR at --hiddenEncoder 2048 (8 heads of dk 256) and at
  --sizeWindow 163840 (S 1024 frames), against the JAX TransformerAR on
  the CPU with the same weights: where JAX's own attention gate
  (``fused_attention_supported``) sends S 1024 to its jnp path, and at dk
  256 its jnp path too (CPC_PALLAS_ATTN off); the port's plain K5 runs on
  the CPU, its kernel on the card (tests/test_torch_cuda.py,
  chip_smoke.py);
* the heads' attention (K2's plain version) at --sizeWindow 163840's
  S 1012 anchors, against JAX's kernel in interpret mode (padded to 1024);
* the LSTM and GRU ARs at --hiddenGar 4096, against the JAX CPCAR's
  ``lax.scan`` at a small batch and window;
* the precision policy: every entry point that runs a step or builds
  features leaves TF32 off for float32 matrix products and cuDNN's
  convolutions, whatever the flags were before.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cpc_audio_tpu.models.ar import CPCAR as JCPCAR
from cpc_audio_tpu.models.transformer import TransformerAR as JTransformerAR
from cpc_audio_tpu.ops.pallas.attention import fused_attention_supported
from cpc_audio_tpu.ops.pallas.head_attention import fused_relpos_attention
from cpc_audio_tpu_torch import convert
from cpc_audio_tpu_torch.config import CPCConfig
from cpc_audio_tpu_torch.criterion import build_criterion
from cpc_audio_tpu_torch.models import CPCAR, TransformerAR, build_model
from cpc_audio_tpu_torch.ops import head_attention


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _bridge(tree) -> dict:
    """A JAX gAR tree (params or gradients) as the port's state dict."""
    sd = convert.params_from_jax({"model": {"gAR": tree}})
    return {k[len("model.gAR."):]: v for k, v in sd.items()}


def _init(module, *args):
    return jax.jit(module.init)({"params": jax.random.PRNGKey(1)},
                                *args)["params"]


def _rel(got: torch.Tensor, want) -> float:
    w = torch.as_tensor(np.array(want, np.float64))
    return ((got.double() - w).norm() / w.norm()).item()


def _check(module, y, y_j, xt, gp_j, gx_j, atol, rel):
    """Output elementwise within ``atol``; the input's and every weight's
    gradient within ``rel`` of its 2-norm."""
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j),
                               atol=atol)
    want = _bridge(gp_j)
    got = {n: p.grad for n, p in module.named_parameters()}
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        assert _rel(g, want[name]) <= rel, (name, _rel(g, want[name]))
    assert _rel(xt.grad, gx_j) <= rel


@pytest.mark.parametrize("B,S,D", [(1, 12, 2048), (1, 1024, 64)],
                         ids=["hiddenEncoder 2048", "sizeWindow 163840"])
def test_transformer_ar_matches_jax_where_the_card_now_runs(
        B, S, D, monkeypatch):
    """One transformer layer (the AR's, whatever nLevelsGRU says) with
    relative positions at rate 0: output and gradients of x and every
    weight (Krelpos included).  At S 1024 JAX's gate refuses its Pallas
    kernel even when it is switched on, so its jnp attention runs; at dk
    256 (D 2048) the jnp path runs by default.  float32 both sides: the
    softmax over up to 1024 keys, the 2048-wide FFN and D-wide products
    sum in another order (2e-4 elementwise, 1e-4 of each gradient's
    2-norm)."""
    monkeypatch.setenv("CPC_PALLAS_ATTN", "1" if S > 512 else "0")
    monkeypatch.setenv("CPC_PALLAS_ATTN_INTERPRET", "1")
    if S > 512:
        assert not fused_attention_supported(S, D // 8, B * 8)
    rng = np.random.RandomState(S + D)
    x = rng.randn(B, S, D).astype(np.float32)
    g = rng.randn(B, S, D).astype(np.float32)
    jar = JTransformerAR(D, 1, S, False)
    params = _init(jar, jnp.asarray(x))
    y_j, vjp = jax.vjp(lambda p, xx: jar.apply({"params": p}, xx)[0],
                       params, jnp.asarray(x))
    gp_j, gx_j = vjp(jnp.asarray(g))
    ar = TransformerAR(D, 1, S, False)
    ar.load_state_dict(_bridge(params))
    xt = _t(x).requires_grad_(True)
    y, _ = ar(xt)
    (y * _t(g)).sum().backward()
    _check(ar, y, y_j, xt, gp_j, gx_j, atol=2e-4, rel=1e-4)


@pytest.mark.parametrize("mode", ["LSTM", "GRU"])
def test_recurrent_ar_at_hidden_gar_4096_matches_jax(mode):
    """--hiddenGar 4096, one layer, B 2, T 3 from 8 input channels: y,
    the carried state and the gradients of x and every weight, against
    the JAX CPCAR (``lax.scan`` at this H, on every backend).  float32;
    4096-deep products in another order (1e-5 elementwise on y, 1e-4 of
    each gradient's 2-norm)."""
    rng = np.random.RandomState(4096)
    B, T, C, H = 2, 3, 8, 4096
    x = rng.randn(B, T, C).astype(np.float32)
    g = rng.randn(B, T, H).astype(np.float32)
    jar = JCPCAR(H, 1, mode)
    params = _init(jar, jnp.asarray(x))
    (y_j, h_j), vjp = jax.vjp(lambda p, xx: jar.apply({"params": p}, xx),
                              params, jnp.asarray(x))
    zeros = jax.tree_util.tree_map(jnp.zeros_like, h_j)
    gp_j, gx_j = vjp((jnp.asarray(g), zeros))
    del vjp
    ar = CPCAR(C, H, 1, mode)
    ar.load_state_dict(_bridge(params))
    del params
    xt = _t(x).requires_grad_(True)
    y, _ = ar(xt)
    (y * _t(g)).sum().backward()
    _check(ar, y, y_j, xt, gp_j, gx_j, atol=1e-5, rel=1e-4)


def test_heads_attention_at_s_1012_matches_pallas_interpret():
    """K2's plain forward and backward at S 1012 (the heads' anchors at
    --sizeWindow 163840), against JAX's ``fused_relpos_attention`` in
    interpret mode, which pads S to 1024 (krel left-padded, as the JAX
    heads do) and is sliced back: output, dq, dk, dv and dkrel at rate 0.
    float32 both sides; softmax over up to 1012 keys in another order
    (2e-5 elementwise on the output, 1e-5 of each gradient's 2-norm)."""
    K, B, S, h, dk, Sp = 1, 1, 1012, 2, 8, 1024
    rng = np.random.RandomState(1012)
    q, k, v = (rng.randn(K, B * S, h * dk).astype(np.float32)
               for _ in range(3))
    krel = (rng.randn(K, dk, S) * 0.5).astype(np.float32)
    dout = rng.randn(K, B * S, h * dk).astype(np.float32)

    def jax_attention(q, k, v, krel):
        def pad(t):
            return jnp.pad(t.reshape(K, B, S, h * dk),
                           ((0, 0), (0, 0), (0, Sp - S), (0, 0))) \
                .reshape(K, B * Sp, h * dk)
        y = fused_relpos_attention(pad(q), pad(k), pad(v),
                                   jnp.pad(krel, ((0, 0), (0, 0), (Sp - S, 0))),
                                   jnp.zeros((1,), jnp.float32), B, h, 0.0,
                                   True)
        return y.reshape(K, B, Sp, h * dk)[:, :, :S].reshape(K, B * S, h * dk)

    y_j, vjp = jax.vjp(jax_attention,
                       *(jnp.asarray(a) for a in (q, k, v, krel)))
    grads_j = vjp(jnp.asarray(dout))
    args = tuple(_t(a) for a in (q, k, v, krel))
    y = head_attention.relpos_attention_ref(*args, B, h)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), atol=2e-5)
    grads = head_attention.relpos_attention_bwd_ref(*args, _t(dout), B, h)
    for name, g, w in zip(("dq", "dk", "dv", "dkrel"), grads, grads_j):
        assert _rel(g, w) <= 1e-5, (name, _rel(g, w))


def test_sizewindow_163840_builds_at_the_default_widths():
    """--arMode transformer --sizeWindow 163840: the AR over 1024 frames
    and the heads over 1012 anchors build, and the transformer AR's
    Krelpos spans 1024 positions."""
    model = build_model(CPCConfig(arMode="transformer", sizeWindow=163840))
    build_criterion(model.config)
    assert model.gAR.layer0.multihead.Krelpos.shape == (32, 1024)


def _run_train_main(tmp_path):
    from cpc_audio_tpu_torch import train
    empty = tmp_path / "db"
    empty.mkdir()
    # no audio: it stops, after the policy, before any step
    assert train.main(["--pathDB", str(empty), "--file_extension", ".wav",
                       "--pathCheckpoint", str(tmp_path / "ckpt"),
                       "--ignore_cache"], device="cpu") != 0


def _run_train_step(tmp_path):
    from cpc_audio_tpu_torch.parallel.train_step import (create_train_state,
                                                         make_train_step)
    model = torch.nn.Linear(2, 2)
    make_train_step(create_train_state(model, torch.nn.Linear(2, 2), "cpu"),
                    "cpu")


def _run_val_step(tmp_path):
    from cpc_audio_tpu_torch.parallel.train_step import make_val_step
    make_val_step(torch.nn.Linear(2, 2), torch.nn.Linear(2, 2), "cpu")


def _run_build_feature(tmp_path):
    from cpc_audio_tpu_torch.feature_loader import build_feature
    with pytest.raises(Exception):       # no such file: after the policy
        build_feature(None, os.path.join(str(tmp_path), "missing.wav"))


ENTRY_POINTS = {"train.main": _run_train_main,
                "make_train_step": _run_train_step,
                "make_val_step": _run_val_step,
                "build_feature": _run_build_feature}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_points_set_the_float32_precision_policy(entry, tmp_path):
    """Both TF32 flags on before the call (PyTorch's cuDNN default, and a
    caller's matmul choice), both off after it: TF32 off under
    --compute_dtype float32, as the JAX package's float32 step on the CPU
    that the port's tests hold it against, and as chip_smoke.py and the
    port_perf scripts now take it from the package."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        ENTRY_POINTS[entry](tmp_path)
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
