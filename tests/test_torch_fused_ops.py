"""The port's fused-layer kernel modules (K6 ``ops/attention_block.py``, K7
``ops/conv_ln.py``) against the JAX package's Pallas kernels, run in
interpret mode on the CPU through the JAX package's own switches, as its
tests/test_attention_kernel.py and tests/test_conv_kernel.py run them.

Inputs come from numpy seeds and go to both packages; everything is
float32, at dropout rate 0 against JAX (the TPU's bits are not
reproduced).  The CUDA kernels themselves run only on a GPU: their parity
with the plain versions is checked by tests/test_torch_cuda.py and by
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cpc_audio_tpu.criterion.stacked_heads import _StackedMHA as JMHA
from cpc_audio_tpu.models.encoder import CONV_KERNELS, CONV_PADS, CONV_STRIDES
from cpc_audio_tpu.models.encoder import CPCEncoder as JEncoder
from cpc_audio_tpu.ops.pallas import conv_ln as jconv_ln
from cpc_audio_tpu.ops.pallas.head_attention import fused_attention_block
from cpc_audio_tpu_torch.convert import params_from_jax
from cpc_audio_tpu_torch.criterion.stacked_heads import _StackedMHA
from cpc_audio_tpu_torch.models import CPCEncoder
from cpc_audio_tpu_torch.ops import attention_block as ab
from cpc_audio_tpu_torch.ops import conv_ln


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, np.float32)).requires_grad_(grad)


def _grads(out, leaves, ct):
    return torch.autograd.grad(out, leaves, _t(ct))


# ---- K6: the heads' whole attention block -----------------------------------

def test_attention_block_matches_pallas_interpret():
    """At the JAX test's size (test_attention_kernel.py:305-343): values
    and the six gradients through the port's autograd Function, which on
    CPU tensors runs attention_block_ref and attention_block_bwd_ref."""
    rng = np.random.RandomState(3)
    K, B, S, h, dk = 3, 4, 128, 4, 16
    D = h * dk
    c = rng.randn(B * S, D).astype(np.float32)
    ws = [(rng.randn(K, D, D) * 0.25).astype(np.float32) for _ in range(4)]
    krel = (rng.randn(K, dk, S) * 0.5).astype(np.float32)
    ct = rng.randn(K, B * S, D).astype(np.float32)
    seed = jnp.zeros((1,), jnp.float32)
    x_j, vjp = jax.vjp(
        lambda *a: fused_attention_block(*a, seed, B, h, 0.0, True),
        *(jnp.asarray(a) for a in (c, *ws, krel)))
    g_j = vjp(jnp.asarray(ct))[:6]

    leaves = [_t(a, True) for a in (c, *ws, krel)]
    x = ab.attention_block(*leaves, B, h)
    np.testing.assert_allclose(x.detach().numpy(), np.asarray(x_j), atol=2e-5)
    for name, got, want in zip(("c", "wq", "wk", "wv", "wo", "krel"),
                               _grads(x, leaves, ct), g_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                                   atol=2e-4, err_msg=name)


def test_attention_block_at_116_matches_the_jax_module_path(monkeypatch):
    """S = 116, the train shapes' anchor count: the JAX module pads it to
    128 for the TPU's lanes and slices back; the port takes S as it is."""
    for var in ("CPC_PALLAS_ATTN", "CPC_PALLAS_ATTN_INTERPRET",
                "CPC_ATTN_BLOCK"):
        monkeypatch.setenv(var, "1")
    rng = np.random.RandomState(9)
    K, B, S, h, D = 2, 2, 116, 4, 64
    c = rng.randn(B, S, D).astype(np.float32)
    net = JMHA(K, D, S, h, include_residual=True)
    params = net.init({"params": jax.random.PRNGKey(0)},
                      jnp.asarray(c))["params"]
    ct = rng.randn(K, B, S, D).astype(np.float32)
    x_j, vjp = jax.vjp(lambda p, c: net.apply({"params": p}, c), params,
                       jnp.asarray(c))
    gp_j, gc_j = vjp(jnp.asarray(ct))

    names = ("Wq", "Wk", "Wv", "Wo")
    ws = [_t(params[n]["kernel"], True) for n in names]
    krel = _t(params["Krelpos"], True)
    c_t = _t(c.reshape(B * S, D), True)
    x = ab.attention_block(c_t, *ws, krel, B, h)
    np.testing.assert_allclose(x.detach().numpy().reshape(K, B, S, D),
                               np.asarray(x_j), atol=2e-5)
    grads = _grads(x, [c_t, *ws, krel], ct.reshape(K, B * S, D))
    want = [np.asarray(gc_j).reshape(B * S, D)] \
        + [np.asarray(gp_j[n]["kernel"]) for n in names] \
        + [np.asarray(gp_j["Krelpos"])]
    for name, got, w in zip(("c",) + names + ("Krelpos",), grads, want):
        np.testing.assert_allclose(got.numpy(), w, rtol=2e-4, atol=2e-4,
                                   err_msg=name)


def test_block_path_drops_as_the_unfused_k2_path():
    """The port's block path against its own unfused path (projections,
    K2, Wo, residual) at rate 0.1 with one seed: the same dropout mask
    (dropout.attention_mask), so values and gradients agree to float32
    rounding; a different seed drops differently."""
    K, S, h, D, B = 2, 30, 4, 64, 3
    gen = torch.Generator().manual_seed(4)
    block = _StackedMHA(K, D, S, h, gen, attention_block=True)
    plain = _StackedMHA(K, D, S, h, None)
    plain.load_state_dict(block.state_dict())
    c = _t(np.random.RandomState(4).randn(B, S, D), True)
    seed = torch.tensor([77])
    ct = np.random.RandomState(5).randn(K, B * S, D)
    outs, grads = [], []
    for mod in (block, plain):
        x = mod(c, 0.1, seed)
        outs.append(x)
        grads.append(_grads(x, [c] + list(mod.parameters()), ct))
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-5, atol=1e-5)
    for gb, gp in zip(*grads):
        torch.testing.assert_close(gb, gp, rtol=1e-4, atol=1e-5)
    other = block(c, 0.1, torch.tensor([78]))
    assert not torch.allclose(other, outs[0], atol=1e-3)


# ---- K7: the fused encoder layer --------------------------------------------

@pytest.mark.parametrize("T,k,s,p,tm", [
    (64, 8, 4, 2, None),      # one tile
    (160, 4, 2, 1, "8"),      # 10 JAX tiles: its cross-tile dx carries
    (640, 8, 4, 2, None),     # layer 1's geometry
])
def test_conv_ln_relu_matches_pallas_interpret(monkeypatch, T, k, s, p, tm):
    """The geometries of test_conv_kernel.py:36-40 at C = 128, with its
    tolerances: values and the five gradients through the port's autograd
    Function (on the CPU: conv_ln_relu_ref and conv_ln_relu_bwd_ref)."""
    if tm is not None:
        monkeypatch.setenv("CPC_CONV_TM", tm)
    rng = np.random.RandomState(1)
    C = 128
    ins = [rng.randn(2, T, C).astype(np.float32),
           (rng.randn(k * C, C) / 30).astype(np.float32),
           (rng.randn(C) * 0.1).astype(np.float32),
           (1 + 0.1 * rng.randn(C)).astype(np.float32),
           (0.1 * rng.randn(C)).astype(np.float32)]
    y_j, vjp = jax.vjp(
        lambda *a: jconv_ln.fused_conv_ln_relu(*a, s, k, p, 1e-5, True),
        *(jnp.asarray(a) for a in ins))
    ct = rng.randn(*y_j.shape).astype(np.float32)
    g_j = vjp(jnp.asarray(ct))

    leaves = [_t(a, True) for a in ins]
    y = conv_ln.conv_ln_relu(*leaves, s, k, p)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), atol=2e-5)
    for name, got, want in zip(("x", "w", "b", "nw", "nb"),
                               _grads(y, leaves, ct), g_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_gate_selects_the_jax_packages_layers_at_the_default_config():
    """Default config (20480 samples, C = 256): JAX's fused_conv_supported
    and the port's gate both pick layers 1-4; layer 0 (C_in = 1) stays on
    the plain conv in both."""
    T, want = 20480, []
    for i, (k, s, p) in enumerate(zip(CONV_KERNELS, CONV_STRIDES,
                                      CONV_PADS)):
        if jconv_ln.fused_conv_supported(T, 1 if i == 0 else 256, k, s, p):
            want.append(i)
        T = (T + 2 * p - k) // s + 1
    assert tuple(want) == (1, 2, 3, 4)
    assert CPCEncoder(256, fused_conv=True).fused_layers(20480) == (1, 2, 3,
                                                                    4)
    assert CPCEncoder(256).fused_layers(20480) == ()


def test_fused_encoder_matches_the_jax_encoder(monkeypatch):
    """CPCEncoder(fused_conv=True) against the JAX CPCEncoder with its gate
    on (interpret mode) on one JAX parameter tree: layers 1-4 fused in
    both.  Values within float32 rounding; gradients per leaf within 1 %
    relative L2, as test_conv_kernel.py:99-132 holds the JAX encoder
    against itself (a pre-activation within rounding of 0 may take the
    other ReLU branch and move a whole row)."""
    monkeypatch.setenv("CPC_PALLAS_CONV", "1")
    monkeypatch.setenv("CPC_PALLAS_CONV_INTERPRET", "1")
    rng = np.random.RandomState(0)
    x = rng.randn(2, 20480).astype(np.float32)
    enc = JEncoder(128)
    params = enc.init({"params": jax.random.PRNGKey(0)},
                      jnp.asarray(x))["params"]
    y_j, vjp = jax.vjp(lambda p: enc.apply({"params": p}, jnp.asarray(x)),
                       params)
    ct = rng.randn(*y_j.shape).astype(np.float32)
    (g_j,) = vjp(jnp.asarray(ct))

    port = CPCEncoder(128, fused_conv=True)
    assert port.fused_layers(20480) == (1, 2, 3, 4)
    sd = params_from_jax({"model": {"gEncoder": params}})
    port.load_state_dict({k[len("model.gEncoder."):]: v
                          for k, v in sd.items()})
    before = conv_ln.conv_ln_relu.launches
    y = port(_t(x))
    assert conv_ln.conv_ln_relu.launches == before   # plain versions on CPU
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j),
                               atol=3e-5)
    names = [n for n, _ in port.named_parameters()]
    grads = _grads(y, list(port.parameters()), ct)
    want = params_from_jax({"model": {"gEncoder": g_j}})
    for name, got in zip(names, grads):
        w = want[f"model.gEncoder.{name}"].numpy()
        err = np.linalg.norm(got.numpy() - w) / (np.linalg.norm(w) + 1e-9)
        assert err < 1e-2, f"{name}: rel L2 {err:.2e}"
