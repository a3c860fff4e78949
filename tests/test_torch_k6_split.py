"""K6's split arithmetic on the CPU: ``attention_block.attention_block_split``
and ``attention_block_bwd_split`` write what the block's body does (its
GEMMs as ``PRODUCTS`` split products of bf16 planes in float32, K2's
tensor-core attention through ``relpos_attention_split`` /
``relpos_attention_bwd_split``) plainly, and are held here

- against float64 (autograd through a float64 block), within a tenth of
  the K6 float32 tolerances of chip_smoke.py (forward 2e-4 elementwise,
  backward 1e-4 of each gradient's norm), at rates 0 and 0.1;
- against the JAX package's float32 ``fused_attention_block`` and its VJP,
  run in interpret mode as tests/test_torch_fused_ops.py runs them, within
  the same tenth, at rate 0 (the TPU's dropout bits are not reproduced);
- in bf16, against the bf16 plain versions, within the card's bf16
  tolerances (forward 2^-4 + 2e-2 |x|, backward 2e-2 of each gradient's
  norm), at rates 0 and 0.1.

The kernels themselves run only on a GPU (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cpc_audio_tpu.ops.pallas.head_attention import fused_attention_block
from cpc_audio_tpu_torch.ops import attention_block as ab
from cpc_audio_tpu_torch.ops import dropout

# (K, B, S, nheads, dk): small shapes, and the train's S 116 at 8 x 32
SHAPES = [(2, 3, 20, 4, 16), (2, 1, 7, 2, 32), (1, 2, 116, 8, 32)]
NAMES = ("dc", "dwq", "dwk", "dwv", "dwo", "dkrel")
FWD_ATOL, BWD_REL = 2e-5, 1e-5      # a tenth of chip_smoke's float32 K6


def _inputs(K, B, S, h, dk, dtype=torch.float32, seed=0):
    rng = np.random.RandomState(seed + S + dk)
    D = h * dk

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(
            np.float32)).to(dtype)
    args = [t(B * S, D)] + [t(K, D, D, scale=D ** -0.5) for _ in range(4)]
    args.append(t(K, dk, S, scale=0.5))
    return args, t(K, B * S, D)


def _block64(c, wq, wk, wv, wo, krel, B, h, mask):
    """The block in float64, differentiable: softmax probabilities times
    the dropout mask (keep / (1 - rate)) before . v."""
    K, (M, D) = wq.shape[0], c.shape
    S, dk = M // B, D // h

    def heads(t):
        return t.reshape(K, B, S, h, dk).transpose(2, 3)
    qh, kh, vh = (heads(c @ w) for w in (wq, wk, wv))
    i = torch.arange(S)[:, None]
    j = torch.arange(S)[None, :]
    qp = torch.einsum("kbhsd,kdr->kbhsr", qh, krel)
    bias = torch.gather(qp, -1, ((j - i - 1) % S).expand(K, B, h, S, S))
    s = (qh @ kh.transpose(-1, -2) + bias) / math.sqrt(dk)
    p = torch.softmax(s.masked_fill(j > i, float("-inf")), -1)
    if mask is not None:
        p = p * mask.double()
    y = (p @ vh).transpose(2, 3).reshape(K, M, D)
    return c + y @ wo


def _rel_norm(got, want):
    got, want = got.double(), want.double()
    return ((got - want).norm() / want.norm()).item()


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("K,B,S,h,dk", SHAPES)
def test_split_against_float64(K, B, S, h, dk, rate):
    args, dout = _inputs(K, B, S, h, dk)
    seed = torch.tensor([21])
    mask = dropout.attention_mask(seed, rate, K, B, h, S, "cpu")
    leaves = [a.double().requires_grad_(True) for a in args]
    x64 = _block64(*leaves, B, h, mask)
    g64 = torch.autograd.grad(x64, leaves, dout.double())
    x = ab.attention_block_split(*args, B, h, rate, seed)
    err = (x.double() - x64.detach()).abs().max().item()
    assert err <= FWD_ATOL, f"forward: max abs err {err:.3e}"
    got = ab.attention_block_bwd_split(*args, dout, B, h, rate, seed)
    for name, g, w in zip(NAMES, got, g64):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        assert _rel_norm(g, w) <= BWD_REL, \
            f"{name}: rel norm err {_rel_norm(g, w):.3e}"


@pytest.mark.parametrize("K,B,S,h,dk", [(2, 2, 20, 4, 16), (1, 2, 7, 2, 32)])
def test_split_against_pallas_interpret(K, B, S, h, dk):
    """The JAX package's float32 block and its VJP in interpret mode."""
    args, dout = _inputs(K, B, S, h, dk, seed=3)
    x_j, vjp = jax.vjp(
        lambda *a: fused_attention_block(*a, jnp.zeros((1,), jnp.float32),
                                         B, h, 0.0, True),
        *(jnp.asarray(a.numpy()) for a in args))
    g_j = vjp(jnp.asarray(dout.numpy()))[:6]
    x = ab.attention_block_split(*args, B, h)
    err = np.abs(x.numpy() - np.asarray(x_j)).max()
    assert err <= FWD_ATOL, f"forward: max abs err {err:.3e}"
    got = ab.attention_block_bwd_split(*args, dout, B, h)
    for name, g, w in zip(NAMES, got, g_j):
        w = torch.from_numpy(np.array(w))
        assert _rel_norm(g, w) <= BWD_REL, \
            f"{name}: rel norm err {_rel_norm(g, w):.3e}"


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("K,B,S,h,dk", SHAPES)
def test_split_bf16_against_plain(K, B, S, h, dk, rate):
    """In bf16 the body's GEMMs are single bf16 products summed in
    float32 and rounded where the plain version rounds; K2's tensor-core
    arithmetic rounds the normalised probabilities as the plain version
    does, so the two differ by float32 summation order."""
    args, dout = _inputs(K, B, S, h, dk, torch.bfloat16)
    seed = torch.tensor([22])
    x = ab.attention_block_split(*args, B, h, rate, seed)
    want = ab.attention_block_ref(*args, B, h, rate, seed)
    assert x.dtype == torch.bfloat16
    torch.testing.assert_close(x.float(), want.float(), atol=2 ** -4,
                               rtol=2e-2)
    got = ab.attention_block_bwd_split(*args, dout, B, h, rate, seed)
    want = ab.attention_block_bwd_ref(*args, dout, B, h, rate, seed)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert _rel_norm(g, w) <= 2e-2, \
            f"{name}: rel norm err {_rel_norm(g, w):.3e}"

