"""The port's modules (cpc_audio_tpu_torch) against the JAX package's, with
the same weights bridged through ``convert.params_from_jax`` and the same
numpy inputs.  Everything is float32 on the CPU, where the port's kernel
wrappers run their plain versions."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cpc_audio_tpu.config import CPCConfig
from cpc_audio_tpu.criterion.stacked_heads import \
    StackedTransformerHeads as JHeads
from cpc_audio_tpu.models.ar import CPCAR as JCPCAR
from cpc_audio_tpu.models.encoder import CPCEncoder as JEncoder
from cpc_audio_tpu.models.norms import ChannelNorm as JChannelNorm
from cpc_audio_tpu_torch import convert
from cpc_audio_tpu_torch.criterion import (StackedTransformerHeads,
                                           build_criterion)
from cpc_audio_tpu_torch.models import (CPCAR, ChannelNorm, CPCEncoder,
                                        build_model)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(module: torch.nn.Module, jax_tree, *path: str) -> None:
    """Load a JAX sub-tree, found at ``model.<path>`` of the full tree,
    into a port module through the bridge."""
    for name in reversed(path):
        jax_tree = {name: jax_tree}
    sd = convert.params_from_jax({"model": jax_tree})
    prefix = ".".join(("model",) + path) + "."
    module.load_state_dict({k[len(prefix):]: v for k, v in sd.items()})


def _init(module, key, *args):
    return module.init({"params": jax.random.PRNGKey(key)}, *args)["params"]


def test_channel_norm_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 9, 16).astype(np.float32) * 3 + 1    # (B, T, C)
    params = {"weight": 1 + 0.1 * rng.randn(16).astype(np.float32),
              "bias": 0.1 * rng.randn(16).astype(np.float32)}
    want = JChannelNorm(16).apply({"params": params}, jnp.asarray(x))
    norm = ChannelNorm(16)
    _load(norm, params, "gEncoder", "norm0")
    got = norm(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)


def test_encoder_matches_jax():
    x = np.random.RandomState(1).randn(2, 1, 3200).astype(np.float32)
    jenc = JEncoder(32)
    params = _init(jenc, 0, jnp.asarray(x))
    want = jenc.apply({"params": params}, jnp.asarray(x))
    enc = CPCEncoder(32)
    _load(enc, params, "gEncoder")
    got = enc(torch.from_numpy(x))
    assert got.shape == (2, 20, 32)
    # f32 convs with sums in another order
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)


def test_ar_matches_jax_with_hidden_carry():
    rng = np.random.RandomState(2)
    B, T, C, H, L = 3, 11, 12, 16, 2
    x = rng.randn(B, T, C).astype(np.float32)
    h0 = (rng.randn(L, B, H) * 0.2).astype(np.float32)
    c0 = (rng.randn(L, B, H) * 0.2).astype(np.float32)
    jar = JCPCAR(H, L, "LSTM")
    params = _init(jar, 1, jnp.asarray(x))
    y_j, (h_j, c_j) = jar.apply({"params": params}, jnp.asarray(x),
                                (jnp.asarray(h0), jnp.asarray(c0)))
    ar = CPCAR(C, H, L)
    _load(ar, params, "gAR")
    y, (h, c) = ar(torch.from_numpy(x),
                   (torch.from_numpy(h0), torch.from_numpy(c0)))
    for got, want in ((y, y_j), (h, h_j), (c, c_j)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-5)
    assert not h.requires_grad and not c.requires_grad   # detached carry


@pytest.mark.parametrize("path", ["xla", "pallas"])
def test_stacked_heads_match_jax(path, monkeypatch):
    """'xla': the JAX package's plain path, with a sequence shorter than
    size_seq (Krelpos sliced).  'pallas': its kernels in interpret mode at
    the eval path's S = 116 (it pads to 128 inside; the port does not)."""
    flag = "1" if path == "pallas" else "0"
    for var in ("CPC_PALLAS_ATTN", "CPC_PALLAS_FFN"):
        monkeypatch.setenv(var, flag)
        monkeypatch.setenv(var + "_INTERPRET", flag)
    K, B = 2, 2
    D, S, size_seq = (128, 116, 116) if path == "pallas" else (64, 20, 24)
    c = np.random.RandomState(3).randn(B, S, D).astype(np.float32)
    jheads = JHeads(K, D, size_seq)
    params = _init(jheads, 2, jnp.asarray(c))
    want = jheads.apply({"params": params}, jnp.asarray(c))
    heads = StackedTransformerHeads(K, D, size_seq)
    _load(heads, params, "heads")
    got = heads(torch.from_numpy(c))
    assert got.shape == (K, B, S, D)
    # f32; attention and the 2048-wide FFN sum in another order
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4)


def test_stacked_heads_match_jax_at_s244_dk64(monkeypatch):
    """The heads of --sizeWindow 40960 --hiddenEncoder 512: S = 244
    anchors, 8 heads of dk = 64.  JAX's Pallas gate refuses the shape at
    every batch, so the JAX package runs its jnp attention; the port runs
    K2 (its plain version here).  Forward and the gradients of c and of
    every weight, float32, weights bridged by convert.params_from_jax."""
    from cpc_audio_tpu.ops.pallas.attention import _padded_len
    from cpc_audio_tpu.ops.pallas.head_attention import \
        relpos_attention_supported
    monkeypatch.setenv("CPC_PALLAS_ATTN", "1")
    monkeypatch.setenv("CPC_PALLAS_ATTN_INTERPRET", "1")
    monkeypatch.setenv("CPC_PALLAS_FFN", "0")
    K, B, D, S = 2, 1, 512, 244
    assert not any(relpos_attention_supported(_padded_len(S), D // 8, 8, b)
                   for b in (B, 32))
    rng = np.random.RandomState(4)
    c = rng.randn(B, S, D).astype(np.float32)
    ct = rng.randn(K, B, S, D).astype(np.float32)
    jheads = JHeads(K, D, S)
    params = _init(jheads, 5, jnp.asarray(c))

    def loss(p, x):
        return jnp.sum(jheads.apply({"params": p}, x) * ct)
    want = jheads.apply({"params": params}, jnp.asarray(c))
    g_params, g_c = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(c))

    heads = StackedTransformerHeads(K, D, S)
    _load(heads, params, "heads")
    x = torch.from_numpy(c).requires_grad_()
    got = heads(x)
    (got * torch.from_numpy(ct)).sum().backward()
    # f32; attention over 244 keys and the 2048-wide FFN sum in another order
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_c), rtol=1e-4,
                               atol=1e-3)
    want_g = convert.params_from_jax({"model": {"heads": g_params}})
    got_g = {"model.heads." + n: p.grad for n, p in heads.named_parameters()}
    assert set(got_g) == set(want_g)
    for name, g in got_g.items():
        w = want_g[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)


def test_stacked_heads_match_jax_at_d384(monkeypatch):
    """The heads of --hiddenEncoder 384 --hiddenGar 384 (8 heads of dk =
    48), a width K3's gate refused until it took every multiple of 32 up
    to 1024: the JAX package runs its jnp attention and tail here (its
    Pallas tail's VMEM gate refuses D 384 at the train rows), the port K2
    and K3 (their plain versions here).  Forward and the gradients of c
    and of every weight at a few rows, float32, dropout off, weights
    bridged by convert.params_from_jax."""
    monkeypatch.setenv("CPC_PALLAS_ATTN", "0")
    monkeypatch.setenv("CPC_PALLAS_FFN", "0")
    K, B, D, S = 2, 2, 384, 12
    rng = np.random.RandomState(384)
    c = rng.randn(B, S, D).astype(np.float32)
    ct = rng.randn(K, B, S, D).astype(np.float32)
    jheads = JHeads(K, D, S)
    params = _init(jheads, 6, jnp.asarray(c))

    def loss(p, x):
        return jnp.sum(jheads.apply({"params": p}, x) * ct)
    want = jheads.apply({"params": params}, jnp.asarray(c))
    g_params, g_c = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(c))

    heads = StackedTransformerHeads(K, D, S)
    _load(heads, params, "heads")
    x = torch.from_numpy(c).requires_grad_()
    got = heads(x)
    (got * torch.from_numpy(ct)).sum().backward()
    # f32; attention over 12 keys and the 2048-wide FFN sum in another
    # order
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_c), rtol=1e-4,
                               atol=1e-3)
    want_g = convert.params_from_jax({"model": {"heads": g_params}})
    got_g = {"model.heads." + n: p.grad for n, p in heads.named_parameters()}
    assert set(got_g) == set(want_g)
    for name, g in got_g.items():
        w = want_g[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)


def test_training_calls_refuse():
    """Training calls need the step's dropout seed and refuse to run
    without one; with it they run, and gradients reach every parameter."""
    cfg = CPCConfig(hiddenEncoder=32, hiddenGar=32, nPredicts=2,
                    negativeSamplingExt=4, sizeWindow=5120)
    model, crit = build_model(cfg), build_criterion(cfg)
    x = torch.from_numpy(np.random.RandomState(0).randn(4, 1, 5120)
                         .astype(np.float32))
    c, z, _, _ = model(x, train=True)
    with pytest.raises(ValueError, match="needs a seed"):
        crit(c, z, train=True)
    with pytest.raises(ValueError, match="needs a seed"):
        crit.wPrediction(c, train=True)
    seed = torch.tensor([3])
    losses, acc = crit(c, z, train=True, seed=seed)
    assert torch.isfinite(losses).all() and acc.shape == (2,)
    losses.sum().backward()
    for name, p in list(model.named_parameters()) + list(
            crit.named_parameters()):
        assert p.grad is not None and torch.isfinite(p.grad).all(), name


PORT_MODULES = (
    "cpc_audio_tpu_torch", "cpc_audio_tpu_torch.train",
    "cpc_audio_tpu_torch.checkpoint", "cpc_audio_tpu_torch.config",
    "cpc_audio_tpu_torch.convert", "cpc_audio_tpu_torch.feature_loader",
    "cpc_audio_tpu_torch.data", "cpc_audio_tpu_torch.utils",
    "cpc_audio_tpu_torch.criterion", "cpc_audio_tpu_torch.models",
    "cpc_audio_tpu_torch.models.transformer",
    "cpc_audio_tpu_torch.parallel.train_step",
    "cpc_audio_tpu_torch.ops._build", "cpc_audio_tpu_torch.ops.native",
    "cpc_audio_tpu_torch.ops.lstm", "cpc_audio_tpu_torch.ops.gru",
    "cpc_audio_tpu_torch.ops.head_attention",
    "cpc_audio_tpu_torch.ops.causal_attention",
    "cpc_audio_tpu_torch.ops.ffn", "cpc_audio_tpu_torch.ops.dropout",
    "cpc_audio_tpu_torch.ops.feistel",
    "cpc_audio_tpu_torch.criterion.custom_layers",
    "cpc_audio_tpu_torch.criterion.prediction",
    "cpc_audio_tpu_torch.models.norms", "cpc_audio_tpu_torch.models.encoder",
    "cpc_audio_tpu_torch.eval.learning_gate")


def test_import_leaves_jax_out():
    """Importing every port module loads neither JAX nor anything of the
    JAX package (the port keeps its own copies of the host modules)."""
    code = ("import sys\n"
            f"import {', '.join(PORT_MODULES)}\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'cpc_audio_tpu'))\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
