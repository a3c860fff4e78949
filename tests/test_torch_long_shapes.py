"""The port past the shapes its kernels once stopped at, against the JAX
package on the CPU: the heads and the transformer AR at S 1040 (past the
old 1024 of K2 and K5) and the LSTM and GRU ARs at H 4104 (past the old
4096 of K1 and K4).  At these shapes the JAX package's own Pallas gates
refuse and it runs its XLA path (jnp attention, ``lax.scan``); the port
runs its kernels' plain versions here, on the CPU (on the card, the
kernels).  Same numpy inputs, weights bridged through
``convert.params_from_jax``; outputs and the gradients of the input and
of every weight, float32."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cpc_audio_tpu.criterion.stacked_heads import \
    StackedTransformerHeads as JHeads
from cpc_audio_tpu.models.ar import CPCAR as JCPCAR
from cpc_audio_tpu.models.transformer import TransformerAR as JTransformerAR
from cpc_audio_tpu.ops.pallas.attention import (_padded_len,
                                                fused_attention_supported)
from cpc_audio_tpu.ops.pallas.head_attention import \
    relpos_attention_supported
from cpc_audio_tpu.ops.pallas.rnn import pallas_rnn_supported
from cpc_audio_tpu_torch import convert
from cpc_audio_tpu_torch.criterion import StackedTransformerHeads
from cpc_audio_tpu_torch.models import CPCAR, TransformerAR
from cpc_audio_tpu_torch.ops import causal_attention, gru, head_attention, lstm

S_LONG = 1040       # anchors, and the AR's frames: past the old S 1024
H_WIDE = 4104       # past the old H 4096


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _bridge(tree, *path: str) -> dict:
    """A JAX sub-tree at ``model.<path>`` as the port's state dict of the
    module there."""
    for name in reversed(path):
        tree = {name: tree}
    sd = convert.params_from_jax({"model": tree})
    prefix = ".".join(("model",) + path) + "."
    return {k[len(prefix):]: v for k, v in sd.items()}


def _random_params(module, seed: int, scale, *args):
    """The module's parameter tree, shapes from ``jax.eval_shape`` (no
    initialiser runs: at H 4104 an orthogonal init would take minutes),
    values seeded normals times ``scale(name, shape)``."""
    shapes = jax.eval_shape(
        lambda *a: module.init({"params": jax.random.PRNGKey(0)}, *a),
        *args)["params"]
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, s: jnp.asarray(
            rng.randn(*s.shape).astype(np.float32)
            * scale(jax.tree_util.keystr(path), s.shape)), shapes)


def _check(got: torch.Tensor, want, atol: float, rtol: float,
           what: str) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=rtol, err_msg=what)


def _check_grads(module: torch.nn.Module, jax_grads, path, atol: float,
                 rtol: float) -> None:
    want = _bridge(jax_grads, *path)
    got = {n: p.grad for n, p in module.named_parameters()}
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        w = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=rtol,
                                   atol=atol * max(np.abs(w).max(), 1e-30),
                                   err_msg=name)


def test_the_gates_take_the_long_and_wide_shapes_jax_leaves_to_xla():
    """At S 1040 and H 4104 the port's gates take the shapes, and the JAX
    package's own Pallas gates refuse the attention (it runs jnp there);
    its recurrence runs lax.scan on the CPU (CPC_PALLAS_RNN=0 below)."""
    assert head_attention.supported(S_LONG, 8) is None
    assert head_attention.fwd_body(S_LONG, 8, torch.float32) == "tc"
    for dt in (torch.bfloat16, torch.float32):
        assert causal_attention.supported(S_LONG, 8, dt) is None
    assert lstm.supported(H_WIDE) is None and gru.supported(H_WIDE) is None
    assert lstm.fwd_body(H_WIDE, torch.float32) == "grid"
    assert not relpos_attention_supported(_padded_len(S_LONG), 8, 8, 1)
    assert not fused_attention_supported(_padded_len(S_LONG), 8, 8)
    assert pallas_rnn_supported(3, 1, 4 * H_WIDE, H_WIDE)   # TPU only


def test_heads_match_jax_at_s1040(monkeypatch):
    """K 2 prediction heads over S 1040 anchors, B 1, D 64 (8 heads of dk
    8): the JAX package's jnp attention (its Pallas gate refuses S past
    512) against the port's K2 plain version, forward and gradients."""
    monkeypatch.setenv("CPC_PALLAS_ATTN", "1")
    monkeypatch.setenv("CPC_PALLAS_ATTN_INTERPRET", "1")
    monkeypatch.setenv("CPC_PALLAS_FFN", "0")
    K, B, D, S = 2, 1, 64, S_LONG
    rng = np.random.RandomState(1040)
    c = rng.randn(B, S, D).astype(np.float32)
    ct = rng.randn(K, B, S, D).astype(np.float32)
    jheads = JHeads(K, D, S)
    params = jheads.init({"params": jax.random.PRNGKey(7)},
                         jnp.asarray(c))["params"]

    def loss(p, x):
        return jnp.sum(jheads.apply({"params": p}, x) * ct)
    want = jheads.apply({"params": params}, jnp.asarray(c))
    g_params, g_c = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(c))

    heads = StackedTransformerHeads(K, D, S)
    heads.load_state_dict(_bridge(params, "heads"))
    x = _t(c).requires_grad_()
    got = heads(x)
    (got * _t(ct)).sum().backward()
    # f32: softmax over up to 1040 keys and the 2048-wide FFN summed in
    # another order
    _check(got, want, 1e-4, 0.0, "heads")
    _check(x.grad, g_c, 1e-3, 1e-4, "dc")
    _check_grads(heads, g_params, ("heads",), 1e-4, 1e-4)


def test_transformer_ar_matches_jax_at_s1040(monkeypatch):
    """The transformer AR over S 1040 frames, B 1, D 64 (8 heads of dk 8),
    rate 0: the JAX package's XLA attention (its Pallas gate refuses S
    past 512) against the port's K5 plain version, forward and
    gradients, Krelpos included."""
    monkeypatch.setenv("CPC_PALLAS_ATTN", "1")
    monkeypatch.setenv("CPC_PALLAS_ATTN_INTERPRET", "1")
    B, S, D = 1, S_LONG, 64
    rng = np.random.RandomState(1041)
    x = rng.randn(B, S, D).astype(np.float32)
    g = rng.randn(B, S, D).astype(np.float32)
    jar = JTransformerAR(D, 1, S, False)
    params = jax.jit(jar.init)({"params": jax.random.PRNGKey(1)},
                               jnp.asarray(x))["params"]
    y_j, vjp = jax.vjp(lambda p, xx: jar.apply({"params": p}, xx)[0],
                       params, jnp.asarray(x))
    gp_j, gx_j = vjp(jnp.asarray(g))
    ar = TransformerAR(D, 1, S, False)
    ar.load_state_dict(_bridge(params, "gAR"))
    xt = _t(x).requires_grad_()
    y, _ = ar(xt)
    (y * _t(g)).sum().backward()
    # f32: softmax over up to 1040 keys and the FFN in another order
    _check(y, y_j, 1e-4, 0.0, "y")
    _check(xt.grad, gx_j, 2e-4, 1e-4, "dx")
    _check_grads(ar, gp_j, ("gAR",), 2e-4, 1e-4)


@pytest.mark.parametrize("mode", ["LSTM", "GRU"])
def test_recurrent_ar_matches_jax_at_h4104(mode, monkeypatch):
    """One LSTM or GRU layer at H 4104, B 1, T 3, from a non-zero state:
    the JAX package's lax.scan against the port's K1 / K4 plain scans
    (on the card, their grid bodies), ys, the final state and the
    gradients of x and of every weight (W_hh alone is 67 M values in the
    LSTM)."""
    monkeypatch.setenv("CPC_PALLAS_RNN", "0")
    B, T, C, H = 1, 3, 8, H_WIDE
    rng = np.random.RandomState(4104)
    x = rng.randn(B, T, C).astype(np.float32)
    h0 = (rng.randn(1, B, H) * 0.2).astype(np.float32)
    c0 = (rng.randn(1, B, H) * 0.2).astype(np.float32)
    gy = rng.randn(B, T, H).astype(np.float32)
    jar = JCPCAR(H, 1, mode)
    hidden = ((jnp.asarray(h0), jnp.asarray(c0)) if mode == "LSTM"
              else jnp.asarray(h0))

    def scale(name, shape):
        return (H ** -0.5 if "weight_hh" in name else
                C ** -0.5 if "weight_ih" in name else 0.1)
    params = _random_params(jar, 41, scale, jnp.asarray(x), hidden)
    (y_j, h_j), vjp = jax.vjp(
        lambda p, xx: jar.apply({"params": p}, xx, hidden), params,
        jnp.asarray(x))
    gp_j, gx_j = vjp((jnp.asarray(gy),
                      jax.tree_util.tree_map(jnp.zeros_like, h_j)))
    ar = CPCAR(C, H, 1, mode)
    ar.load_state_dict(_bridge(params, "gAR"))
    del params
    xt = _t(x).requires_grad_()
    y, h = ar(xt, (_t(h0), _t(c0)) if mode == "LSTM" else _t(h0))
    # f32: each step's 4104-deep products summed in another order
    _check(y, y_j, 1e-5, 1e-5, "ys")
    for got, want in (zip(h, h_j) if mode == "LSTM" else ((h, h_j),)):
        _check(got, want, 1e-5, 1e-5, "final state")
    (y * _t(gy)).sum().backward()
    _check(xt.grad, gx_j, 1e-4, 1e-4, "dx")
    _check_grads(ar, gp_j, ("gAR",), 1e-4, 1e-4)
