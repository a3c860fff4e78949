"""The float32 K3 split arithmetic, written plainly on the CPU.

On the card K3's float32 forward and backward (csrc/layer_tail_tc.cu) run
their products (two and six) on bf16 tensor cores with split operands: a
float32 a is kept as bf16 planes a0 = bf16(a), a1 = bf16(a - a0) (and a2 =
bf16(a - a0 - a1)), and a product sums 3 (or, in the backward's G1, 6)
products of planes in float32 accumulators.  ``ffn.split_matmul``,
``ffn.layer_tail_fwd_split`` and ``ffn.layer_tail_bwd_split`` are that
arithmetic in plain PyTorch; here they are held against float64 products,
against the JAX package's float32 ``fused_layer_tail`` and ``_tail_bwd``
(its custom VJP; both in interpret mode) and against the port's plain
versions.  The kernels themselves run only on a GPU
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
# the forward's output, max |got - want| <= 1e-4 max |want|: F-long and
# D-long float32 sums in another order, and G2's product of 3 split terms
# within 2^-16 of |a||b| (test_split_product_within_its_bound)
FWD_REL = 1e-4


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


def test_split_forward_matches_pallas_forward():
    """At rate 0, the inputs of test_split_backward_matches_pallas_vjp,
    against the JAX package's float32 forward in interpret mode."""
    K, M, D, F = 2, 64, 128, 256
    args = [a.astype(np.float32)
            for a in _tail_inputs(np.random.RandomState(13), K, M, D, F)]
    want = np.asarray(fused_layer_tail(*map(jnp.asarray, args),
                                       jnp.zeros((1,), jnp.float32), 0.0,
                                       1e-5, True), np.float64)
    got = ffn.layer_tail_fwd_split(*map(_t, args)).double().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= FWD_REL * np.abs(want).max()


def test_split_forward_matches_plain_forward_with_dropout():
    """At rate 0.1 against the port's plain forward with the same seed."""
    K, M, D, F = 2, 64, 128, 256
    args = [_t(a) for a in _tail_inputs(np.random.RandomState(13), K, M, D,
                                        F)]
    seed = torch.tensor([5])
    got = ffn.layer_tail_fwd_split(*args, 1e-5, 0.1, seed).double()
    want = ffn.layer_tail_ref(*args, 1e-5, 0.1, seed).double()
    exact = ffn.layer_tail_ref(*[a.double() for a in args], 1e-5, 0.1, seed)
    assert exact.dtype == torch.float64
    for ref in (want, exact):
        assert (got - ref).abs().max() <= FWD_REL * ref.abs().max()


def test_forcing_live_bits_moves_only_the_first_products_gradients():
    """``force_live`` of layer_tail_bwd_ref: forcing every kept unit to
    its own live bit changes nothing, bit for bit; flipping one unit moves
    dx, dln1w, dln1b, dw1 and db1 and leaves the rest as they are."""
    K, M, D, F = 2, 24, 64, 128
    args = [_t(a) for a in _tail_inputs(np.random.RandomState(3), K, M, D,
                                        F)]
    dout = _t(np.random.RandomState(4).randn(K, M, D))
    seed = torch.tensor([5])
    base = ffn.layer_tail_bwd_ref(*args, dout, 1e-5, 0.1, seed)
    y = ffn._affine(ffn._ln(args[0], 1e-5)[0], args[1], args[2])
    h = torch.relu(y @ args[3] + args[4][:, None]) * \
        ffn.dropout.ffn_mask(seed, 0.1, K, M, F, "cpu")
    units = torch.nonzero(torch.ones(K, M, F, dtype=torch.bool))
    same = ffn.layer_tail_bwd_ref(*args, dout, 1e-5, 0.1, seed,
                                  force_live=(units, (h > 0).flatten()))
    for name, g, w in zip(NAMES, same, base):
        assert torch.equal(g, w), name
    # a live unit taken as dead: its row's dh no longer passes
    unit = torch.nonzero(h > 0)[7:8]
    flipped = ffn.layer_tail_bwd_ref(*args, dout, 1e-5, 0.1, seed,
                                     force_live=(unit, torch.tensor([False])))
    moved = {name for name, g, w in zip(NAMES, flipped, base)
             if not torch.equal(g, w)}
    assert moved == {"dx", "dln1w", "dln1b", "dw1", "db1"}
