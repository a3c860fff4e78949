"""The float32 K3 backward's split arithmetic, written plainly on the CPU.

On the card K3's float32 backward (csrc/layer_tail_bwd_tc.cu) runs its six
products on bf16 tensor cores with split operands: a float32 a is kept as
bf16 planes a0 = bf16(a), a1 = bf16(a - a0) (and a2 = bf16(a - a0 - a1)),
and a product sums 3 (or, in G1, 6) products of planes in float32
accumulators.  ``ffn.split_matmul`` and ``ffn.layer_tail_bwd_split`` are
that arithmetic in plain PyTorch; here they are held against float64
products, against the JAX package's float32 ``_tail_bwd`` (through
``fused_layer_tail``'s custom VJP in interpret mode) and against the
port's plain backward.  The kernel itself runs only on a GPU
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cpc_audio_tpu.ops.pallas.ffn import fused_layer_tail
from cpc_audio_tpu_torch.ops import ffn

NAMES = ("dx", "dln1w", "dln1b", "dw1", "db1", "dw2", "db2", "dln2w",
         "dln2b")
# tests/test_torch_cuda.py's BWD_REL for float32: max |got - want| <= 1e-4
# max |want|, each gradient
BWD_REL = 1e-4


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def test_three_planes_hold_float32_exactly():
    """y (G1's A operand) travels as three planes: their sum is y."""
    a = _t(np.random.RandomState(0).randn(4096) *
           np.exp(np.random.RandomState(1).uniform(-20, 20, 4096)))
    p0, p1, p2 = ffn.split_planes(a, 3)
    assert torch.equal((p0 + p1) + p2, a)
    for p in (p0, p1, p2):
        assert torch.equal(p, p.to(torch.bfloat16).float())


# One head of the default train shape (M 3712, D 256, F 2048).  Each
# dropped term of a product of 3 split terms (a1 b1, a0 rb, ra b0 with
# ra = a - a0 - a1) is at most 2^-16 |a||b|, of 6 terms 2^-24, and the
# float32 sum of P * depth terms adds at most P * depth * 2^-24 |a||b|:
# the elementwise bound against the float64 product, relative to |A| |B|.
# In norm, where the errors' signs vary, 3 terms stay within 2^-16 of
# ||AB|| (a bf16 product: 2^-8) and 6 within 2^-21 (float32's own).
@pytest.mark.parametrize("use,products,norm_bound", [
    ("G3 df W2^T", 3, 2.0 ** -16), ("G1 y W1", 6, 2.0 ** -21)])
def test_split_product_within_its_bound(use, products, norm_bound):
    M, D, F = 3712, 256, 2048
    rng = np.random.RandomState(products)
    a = rng.randn(1, M, D).astype(np.float32)
    b = (rng.randn(1, D, F) / np.sqrt(D)).astype(np.float32)
    got = ffn.split_matmul(_t(a), _t(b), products).double()
    A, B = torch.from_numpy(a).double(), torch.from_numpy(b).double()
    exact = A @ B
    term = 3 * 2.0 ** -16 if products == 3 else 3 * 2.0 ** -24
    bound = (term + products * D * 2.0 ** -24) * (A.abs() @ B.abs())
    assert ((got - exact).abs() <= bound).all(), use
    assert (got - exact).norm() <= norm_bound * exact.norm(), use


def _tail_inputs(rng, K, M, D, F):
    return (rng.randn(K, M, D) * 0.5, 1.0 + 0.1 * rng.randn(K, D),
            0.1 * rng.randn(K, D), rng.randn(K, D, F) / np.sqrt(D),
            0.1 * rng.randn(K, F), rng.randn(K, F, D) / np.sqrt(F),
            0.1 * rng.randn(K, D), 1.0 + 0.1 * rng.randn(K, D),
            0.1 * rng.randn(K, D))


def _grads_close(got, want, rel):
    """max |got - want| <= rel * max |want| per gradient."""
    for name, g, w in zip(NAMES, got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, (name, g.shape, w.shape)
        err = np.abs(g - w).max()
        assert err <= rel * np.abs(w).max() + 1e-7, (name, err)


def test_split_backward_matches_pallas_vjp():
    """At rate 0, the inputs of test_torch_ops'
    test_layer_tail_bwd_ref_matches_pallas_vjp."""
    K, M, D, F = 2, 64, 128, 256
    args = [a.astype(np.float32)
            for a in _tail_inputs(np.random.RandomState(13), K, M, D, F)]
    dout = np.random.RandomState(14).randn(K, M, D).astype(np.float32)
    seed = jnp.zeros((1,), jnp.float32)
    _, vjp = jax.vjp(lambda *a: fused_layer_tail(*a, seed, 0.0, 1e-5, True),
                     *map(jnp.asarray, args))
    want = vjp(jnp.asarray(dout))
    got = ffn.layer_tail_bwd_split(*map(_t, args), _t(dout))
    _grads_close(got, want, BWD_REL)


def test_split_backward_matches_plain_backward_with_dropout():
    """At rate 0.1 against the port's plain backward with the same seed
    (the JAX kernel draws its dropout bits from the TPU's generator, the
    port from ops/dropout.py: docs/DESIGN.md)."""
    K, M, D, F = 2, 64, 128, 256
    args = [_t(a) for a in _tail_inputs(np.random.RandomState(13), K, M, D,
                                        F)]
    dout = _t(np.random.RandomState(14).randn(K, M, D))
    seed = torch.tensor([5])
    got = ffn.layer_tail_bwd_split(*args, dout, 1e-5, 0.1, seed)
    want = ffn.layer_tail_bwd_ref(*args, dout, 1e-5, 0.1, seed)
    _grads_close(got, want, BWD_REL)


def test_plain_backward_in_float64_matches_float32():
    """The exact version chip_smoke.py and port_perf/k3_ab.py hold the
    float32 kernel against: layer_tail_bwd_ref on float64 inputs."""
    K, M, D, F = 2, 24, 64, 128
    args = [_t(a) for a in _tail_inputs(np.random.RandomState(3), K, M, D,
                                        F)]
    dout = _t(np.random.RandomState(4).randn(K, M, D))
    exact = ffn.layer_tail_bwd_ref(*[a.double() for a in args],
                                   dout.double())
    assert all(g.dtype == torch.float64 for g in exact)
    _grads_close(ffn.layer_tail_bwd_ref(*args, dout), exact, 1e-5)
