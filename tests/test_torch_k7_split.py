"""K7's split arithmetic on the CPU: ``conv_ln.conv_ln_split`` and
``conv_ln_bwd_split`` write what the fused encoder layer's body does (its
conv, dx and dW as ``PRODUCTS`` split products of bf16 planes in float32,
the norm's chain in float32, dh rounded to x's dtype), and are held here

- against float64 (autograd through a float64 plain layer), within a
  tenth of the K7 float32 tolerances of chip_smoke.py (forward 2e-4
  elementwise, backward 1e-3 of each gradient's norm);
- against the JAX package's float32 ``fused_conv_ln_relu`` and its VJP,
  run in interpret mode as tests/test_torch_fused_ops.py runs them, within
  the same tenth, at C 64 and 128 and a few dozen frames;
- in bf16, against the bf16 plain versions, within the card's bf16
  tolerances (forward 1e-2 + 2e-2 |x|, backward 2e-2 of each gradient's
  norm).

The kernels themselves run only on a GPU (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cpc_audio_tpu.ops.pallas.conv_ln import fused_conv_ln_relu
from cpc_audio_tpu_torch.ops import conv_ln as cl

# (B, T, C, kernel, stride, pad): layer 1's and layers 2-4's geometry, a
# T that leaves a padded row no frame reads, and a frame reaching into
# the padding at both ends
SHAPES = [(2, 96, 256, 8, 4, 2), (2, 64, 256, 4, 2, 1), (3, 33, 64, 4, 2, 1),
          (2, 5, 128, 8, 4, 2)]
NAMES = ("dx", "dw", "db", "dnw", "dnb")
FWD_ATOL, BWD_REL = 2e-5, 1e-4      # a tenth of chip_smoke's float32 K7


def _inputs(B, T, C, k, dtype=torch.float32, seed=0):
    rng = np.random.RandomState(seed + T + C)

    def t(*shape, scale=1.0, shift=0.0, dt=dtype):
        return torch.from_numpy((rng.randn(*shape) * scale + shift).astype(
            np.float32)).to(dt)
    f32 = torch.float32
    args = [t(B, T, C).abs(), t(k * C, C, scale=(k * C) ** -0.5),
            t(C, scale=0.1, dt=f32), t(C, scale=0.1, shift=1.0, dt=f32),
            t(C, scale=0.1, dt=f32)]
    return args


def _dy(B, T, C, k, s, p, dtype=torch.float32, seed=0):
    rng = np.random.RandomState(seed + 7 * T + C)
    out_t = cl.out_frames(T, k, s, p)
    return torch.from_numpy((rng.randn(B, out_t, C) * 0.1).astype(
        np.float32)).to(dtype)


def _rel_norm(got, want):
    got, want = got.double(), want.double()
    return ((got - want).norm() / want.norm()).item()


@pytest.mark.parametrize("B,T,C,k,s,p", SHAPES)
def test_split_against_float64(B, T, C, k, s, p):
    args = _inputs(B, T, C, k)
    dy = _dy(B, T, C, k, s, p)
    leaves = [a.double().requires_grad_(True) for a in args]
    y64 = cl.conv_ln_relu_ref(*leaves, s, k, p)
    g64 = torch.autograd.grad(y64, leaves, dy.double())
    y = cl.conv_ln_split(*args, s, k, p)
    err = (y.double() - y64.detach()).abs().max().item()
    assert err <= FWD_ATOL, f"forward: max abs err {err:.3e}"
    got = cl.conv_ln_bwd_split(*args, dy, s, k, p)
    for name, g, w in zip(NAMES, got, g64):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        assert _rel_norm(g, w) <= BWD_REL, \
            f"{name}: rel norm err {_rel_norm(g, w):.3e}"


@pytest.mark.parametrize("B,T,C,k,s,p", [(2, 64, 64, 8, 4, 2),
                                         (2, 48, 128, 4, 2, 1)])
def test_split_against_pallas_interpret(B, T, C, k, s, p):
    """The JAX package's float32 layer and its VJP in interpret mode."""
    args = _inputs(B, T, C, k, seed=3)
    dy = _dy(B, T, C, k, s, p, seed=3)
    y_j, vjp = jax.vjp(
        lambda *a: fused_conv_ln_relu(*a, s, k, p, 1e-5, True),
        *(jnp.asarray(a.numpy()) for a in args))
    g_j = vjp(jnp.asarray(dy.numpy()))
    y = cl.conv_ln_split(*args, s, k, p)
    err = np.abs(y.numpy() - np.asarray(y_j)).max()
    assert err <= FWD_ATOL, f"forward: max abs err {err:.3e}"
    got = cl.conv_ln_bwd_split(*args, dy, s, k, p)
    for name, g, w in zip(NAMES, got, g_j):
        w = torch.from_numpy(np.array(w))
        assert _rel_norm(g, w) <= BWD_REL, \
            f"{name}: rel norm err {_rel_norm(g, w):.3e}"


@pytest.mark.parametrize("B,T,C,k,s,p", SHAPES)
def test_split_bf16_against_plain(B, T, C, k, s, p):
    """In bf16 the body's GEMMs are single bf16 products summed in float32
    and rounded where the plain version rounds (the output, dh, dx), so
    the two differ by float32 summation order."""
    args = _inputs(B, T, C, k, torch.bfloat16)
    dy = _dy(B, T, C, k, s, p, torch.bfloat16)
    y = cl.conv_ln_split(*args, s, k, p)
    want = cl.conv_ln_relu_ref(*args, s, k, p)
    assert y.dtype == torch.bfloat16
    torch.testing.assert_close(y.float(), want.float(), atol=1e-2,
                               rtol=2e-2)
    got = cl.conv_ln_bwd_split(*args, dy, s, k, p)
    want = cl.conv_ln_relu_bwd_ref(*args, dy, s, k, p)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert _rel_norm(g, w) <= 2e-2, \
            f"{name}: rel norm err {_rel_norm(g, w):.3e}"
