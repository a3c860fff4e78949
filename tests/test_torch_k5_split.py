"""K5's float32 tensor-core arithmetic, written plainly on the CPU.

On the card K5's float32 forward and backward (csrc/causal_attention_fwd.cu,
csrc/causal_attention_bwd.cu) run every product on bf16 tensor cores with
split operands.  The forward splits q, k, v and the probabilities into
three bf16 planes each and sums the six split products plane i . plane j,
i + j < 3, in float32; the backward splits q, k, v, do, the probabilities
and ds into two planes hi + lo and takes three, hi.hi + hi.lo + lo.hi.
``causal_attention.causal_attention_split`` and
``causal_attention_bwd_split`` are that arithmetic in plain PyTorch; here
they are held against float64 math and against the JAX package's float32
``fused_causal_attention`` and its custom VJP (interpret mode), within a
tenth of chip_smoke.py's float32 K5 tolerances (the forward elementwise
2e-4, each backward output 1e-4 of its 2-norm), the error the kernels
aim at.  The kernels themselves run only on a GPU
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cpc_audio_tpu.ops.pallas.attention import fused_causal_attention
from cpc_audio_tpu_torch.ops import causal_attention as ca

# chip_smoke.py's TOLERANCE for K5 in float32
FWD_ATOL = 2e-4
BWD_REL = 1e-4


def _inputs(N, S, dk, seed):
    """chip_smoke's K5 inputs: q, k, v ~ N(0, 1), the bias ~ N(0, 0.25),
    the cotangent of the output ~ N(0, 0.01)."""
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(N, S, dk).astype(np.float32) for _ in range(3))
    bias = (rng.randn(N, S, S) * 0.5).astype(np.float32)
    dout = (rng.randn(N, S, dk) * 0.1).astype(np.float32)
    return q, k, v, bias, dout


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _rel(got, want):
    return ((torch.as_tensor(np.asarray(got)).double()
             - torch.as_tensor(np.asarray(want)).double()).norm()
            / torch.as_tensor(np.asarray(want)).double().norm()).item()


# (N, S, dk; N a multiple of the JAX kernel's 8 rows a step): S 60 ends
# in a ragged tile; dk 512 and 264 run the DKP 512
# tiles (16 rows, q . k^T and do . v^T by quarters of dk)
CASES = [(8, 16, 32), (8, 60, 32), (8, 128, 32), (8, 128, 64), (8, 40, 512),
         (8, 36, 264)]


@pytest.mark.parametrize("N,S,dk", CASES)
def test_split_forward_matches_float64_and_pallas(N, S, dk):
    """The split forward against the float64 plain forward, within a
    tenth of the card's float32 tolerance, and JAX's float32 kernel in
    interpret mode (S 60 is padded inside the JAX kernel, to 64), within
    that tolerance."""
    q, k, v, bias, _ = _inputs(N, S, dk, N + S + dk)
    got = ca.causal_attention_split(*(_t(a) for a in (q, k, v, bias)))
    exact = ca.causal_attention_ref(*(_t(a, torch.float64)
                                      for a in (q, k, v, bias)))
    seed = jnp.zeros((1,), jnp.float32)
    jax_out = fused_causal_attention(*(jnp.asarray(a) for a in
                                       (q, k, v, bias)), seed, 0.0, True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), exact.numpy(),
                               atol=FWD_ATOL / 10, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_out),
                               atol=FWD_ATOL, rtol=0)


@pytest.mark.parametrize("N,S,dk", CASES)
def test_split_backward_matches_float64_and_pallas_vjp(N, S, dk):
    """dq, dk, dv and dbias of the split backward against the float64
    plain backward, each within a tenth of the card's float32 tolerance
    of its 2-norm, and ``jax.vjp`` of JAX's kernel in interpret mode,
    within that tolerance."""
    q, k, v, bias, dout = _inputs(N, S, dk, 3 * N + S + dk)
    got = ca.causal_attention_bwd_split(*(_t(a) for a in
                                          (q, k, v, bias, dout)))
    exact = ca.causal_attention_bwd_ref(*(_t(a, torch.float64) for a in
                                          (q, k, v, bias, dout)))
    seed = jnp.zeros((1,), jnp.float32)
    _, vjp = jax.vjp(lambda *a: fused_causal_attention(*a, seed, 0.0, True),
                     *(jnp.asarray(a) for a in (q, k, v, bias)))
    jax_grads = vjp(jnp.asarray(dout))
    for name, g, e, j in zip(("dq", "dk", "dv", "dbias"), got, exact,
                             jax_grads):
        assert g.dtype == torch.float32, name
        assert _rel(g, e) <= BWD_REL / 10, (name, _rel(g, e))
        assert _rel(g, j) <= BWD_REL, (name, _rel(g, j))


@pytest.mark.parametrize("dk", [32, 128, 512])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_split_goes_by_the_kernels_key_tiles(rate, dk):
    """The kernel's order: keys by tiles of 64 (32 past a row's 128 planes'
    values: in the forward's three float32 planes past dk 32; 16 past dk
    256), the probabilities split as exp(s - running max) r, the partial
    output rescaled as the max moves; S 100 ends in a ragged tile.  Within
    a tenth of the card's float32 tolerance of float64 math."""
    q, k, v, bias, _ = _inputs(8, 100, dk, 7)
    seed = torch.tensor([3], dtype=torch.int64)
    args = tuple(_t(a) for a in (q, k, v, bias))
    exact = ca.causal_attention_ref(*(a.double() for a in args), rate, seed)
    got = ca.causal_attention_split(*args, rate, seed)
    assert (got.double() - exact).abs().max().item() <= FWD_ATOL / 10
    assert ca.key_tile(32, ca.FWD_PLANES) == ca.key_tile(64, ca.BWD_PLANES) \
        == ca.key_tile(128, 1) == 64
    assert ca.key_tile(64, ca.FWD_PLANES) == ca.key_tile(128, ca.BWD_PLANES) \
        == ca.key_tile(256, 1) == ca.key_tile(200, ca.FWD_PLANES) == 32
    assert ca.key_tile(264, 1) == ca.key_tile(512, ca.FWD_PLANES) \
        == ca.key_tile(512, ca.BWD_PLANES) == 16


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_split_error_stays_a_fraction_of_the_tolerance(rate):
    """Why six split products in the forward and three in the backward:
    at S 128, dk 64 (here N 8) the forward's six stay within a hundredth
    of the float32 forward tolerance, where three (two planes) reach 16 %
    of it with dropout (r = 1 / 0.9 is no short bf16 value), past the
    tenth the kernels aim at; the backward's three stay within a tenth of
    its tolerance, with dropout too."""
    q, k, v, bias, dout = _inputs(8, 128, 64, 5)
    seed = torch.tensor([3], dtype=torch.int64)
    args = tuple(_t(a) for a in (q, k, v, bias))
    exact = ca.causal_attention_ref(*(a.double() for a in args), rate, seed)
    six = (ca.causal_attention_split(*args, rate, seed).double()
           - exact).abs().max().item()
    assert six <= FWD_ATOL / 100, six
    three = (ca.causal_attention_split(*args, rate, seed, products=3)
             .double() - exact).abs().max().item()
    assert six < three / 20, (six, three)
    if rate:
        assert three > FWD_ATOL / 10, three
    exact_b = ca.causal_attention_bwd_ref(*(a.double() for a in args),
                                          _t(dout, torch.float64), rate,
                                          seed)
    got_b = ca.causal_attention_bwd_split(*args, _t(dout), rate, seed)
    worst = max(_rel(g, e) for g, e in zip(got_b, exact_b))
    assert worst <= BWD_REL / 10, worst


def test_split_planes_carry_16_bits():
    """hi = bf16(x), lo = bf16(x - hi): hi + lo is x to 2^-17 relative,
    where hi alone keeps 2^-9."""
    from cpc_audio_tpu_torch.ops import ffn
    x = torch.randn(4096, dtype=torch.float32)
    hi, lo = ffn.split_planes(x, 2)
    rel = ((hi + lo - x).abs() / x.abs()).max().item()
    assert rel <= 2.0 ** -16, rel
    assert ((hi - x).abs() / x.abs()).max().item() > 2.0 ** -12
