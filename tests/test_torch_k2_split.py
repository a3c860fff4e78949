"""K2's tensor-core arithmetic, written plainly on the CPU.

On the card K2's forward and backward (csrc/relpos_attention_tc_fwd.cu,
csrc/relpos_attention_tc_bwd.cu) go by tiles of T query rows and keys
and, for each tile pair, the window of 2T krel columns its diagonal
reads: the bias is the window product QP = q . krel[:, window] read at
column j - i + T - 1, and the backward's rel-pos adjoint runs on the
unskewed ds U (T x 2T).  In float32 every product runs on bf16 tensor
cores with split operands: three planes and six split products in the
forward, two planes and three in the backward.
``head_attention.relpos_attention_split`` and
``relpos_attention_bwd_split`` are that arithmetic in plain PyTorch, with
the kernel's T and index arithmetic; here they are held against float64
math and against the JAX package's float32 ``fused_relpos_attention`` and
its custom VJP (interpret mode), within a tenth of chip_smoke.py's float32
K2 tolerances (the forward elementwise 2e-4, each backward output 1e-4 of
its 2-norm), the error the kernels aim at; the bf16 arithmetic against
the bf16 plain versions within chip_smoke's bf16 tolerances.  The kernels
themselves run only on a GPU (tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cpc_audio_tpu.ops.pallas.head_attention import fused_relpos_attention
from cpc_audio_tpu_torch.ops import head_attention as ha

# chip_smoke.py's TOLERANCE for K2: float32 forward elementwise, backward
# on each gradient's 2-norm; bf16 forward (atol, rtol), backward
FWD_ATOL = 2e-4
BWD_REL = 1e-4
BF16_FWD = dict(atol=1e-2, rtol=2e-2)
BF16_BWD_REL = 2e-2

# (K, B, h, S, dk): S 7 and 65 end in a ragged tile (and S 7 < T reads a
# window that starts below column 0); 116, 244 and 1012 are the heads'
# anchors at --sizeWindow 20480, 40960 and 163840; dk 512 and 264 run the
# DKP 512 tiles (16 rows, the products over dk by quarters; 264 leaves the
# last quarter empty), S 130 ending in a ragged tile; dk 520 and 1024 the
# cluster body's (two 512-column slabs, the second one of 8 columns at
# 520: the products over dk by the slabs' quarters, the slabs summed)
CLUSTER_SHAPES = [(2, 2, 2, 20, 520), (2, 2, 2, 20, 1024)]
SHAPES = [(2, 2, 2, 7, 32), (2, 2, 2, 65, 25), (2, 2, 2, 116, 32),
          (2, 2, 2, 116, 64), (1, 2, 2, 244, 32), (1, 1, 1, 1012, 32),
          (1, 1, 1, 40, 512), (1, 2, 1, 130, 264)] + CLUSTER_SHAPES


def _inputs(K, B, h, S, dk, seed):
    """chip_smoke's K2 inputs: q, k, v ~ N(0, 1), krel ~ N(0, 0.25), the
    output's cotangent ~ N(0, 0.01)."""
    rng = np.random.RandomState(seed)
    D = h * dk
    q, k, v = (rng.randn(K, B * S, D).astype(np.float32) for _ in range(3))
    krel = (rng.randn(K, dk, S) * 0.5).astype(np.float32)
    dout = (rng.randn(K, B * S, D) * 0.1).astype(np.float32)
    return q, k, v, krel, dout


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _rel(got, want):
    got = torch.as_tensor(np.asarray(got, np.float64))
    want = torch.as_tensor(np.asarray(want, np.float64))
    return ((got - want).norm() / want.norm()).item()


def _jax_relpos_fn(B, S, h):
    """fused_relpos_attention in interpret mode on unpadded inputs: S
    padded to a multiple of 128 and krel left-padded inside, as
    stacked_heads.py does on the JAX side (tests/test_torch_ops.py)."""
    Sp = -(-S // 128) * 128

    def f(q, k, v, krel):
        K, _, D = q.shape

        def pad(t):
            t = t.reshape(K, B, S, D)
            return jnp.pad(t, ((0, 0), (0, 0), (0, Sp - S), (0, 0))) \
                .reshape(K, B * Sp, D)

        kr = jnp.pad(krel, ((0, 0), (0, 0), (Sp - S, 0)))
        y = fused_relpos_attention(pad(q), pad(k), pad(v), kr,
                                   jnp.zeros((1,), jnp.float32), B, h, 0.0,
                                   True)
        return y.reshape(K, B, Sp, D)[:, :, :S].reshape(K, B * S, D)
    return f


@pytest.mark.parametrize("K,B,h,S,dk", SHAPES)
def test_split_forward_matches_float64_and_pallas(K, B, h, S, dk):
    """The split forward against the float64 plain forward and JAX's
    float32 kernel in interpret mode, each within a tenth of the card's
    float32 tolerance."""
    q, k, v, krel, _ = _inputs(K, B, h, S, dk, S + dk)
    got = ha.relpos_attention_split(*(_t(a) for a in (q, k, v, krel)), B, h)
    exact = ha.relpos_attention_ref(*(_t(a, torch.float64)
                                      for a in (q, k, v, krel)), B, h)
    jax_out = _jax_relpos_fn(B, S, h)(*map(jnp.asarray, (q, k, v, krel)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), exact.numpy(),
                               atol=FWD_ATOL / 10, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_out),
                               atol=FWD_ATOL / 10, rtol=0)


@pytest.mark.parametrize("K,B,h,S,dk", SHAPES)
def test_split_backward_matches_float64_and_pallas_vjp(K, B, h, S, dk):
    """dq, dk, dv and dkrel of the split backward against the float64
    plain backward and ``jax.vjp`` of JAX's kernel in interpret mode, each
    within a tenth of the card's float32 tolerance of its 2-norm."""
    q, k, v, krel, dout = _inputs(K, B, h, S, dk, 3 * S + dk)
    got = ha.relpos_attention_bwd_split(*(_t(a) for a in
                                          (q, k, v, krel, dout)), B, h)
    exact = ha.relpos_attention_bwd_ref(*(_t(a, torch.float64) for a in
                                          (q, k, v, krel, dout)), B, h)
    _, vjp = jax.vjp(_jax_relpos_fn(B, S, h),
                     *map(jnp.asarray, (q, k, v, krel)))
    jax_grads = vjp(jnp.asarray(dout))
    for name, g, e, j in zip(("dq", "dk", "dv", "dkrel"), got, exact,
                             jax_grads):
        assert g.dtype == torch.float32, name
        assert g.shape == e.shape, name
        assert _rel(g, e) <= BWD_REL / 10, (name, _rel(g, e))
        assert _rel(g, j) <= BWD_REL / 10, (name, _rel(g, j))


@pytest.mark.parametrize("K,B,h,S,dk", SHAPES[:4] + [(1, 1, 1, 1012, 32),
                                                     (1, 1, 1, 40, 512)])
def test_split_with_dropout_matches_float64(K, B, h, S, dk):
    """At rate 0.1 (the train step's; the TPU's bits are not reproduced,
    so against float64 math only, with the same seed): the forward within
    a tenth of its float32 tolerance, each backward output within a tenth
    of its tolerance of the 2-norm."""
    q, k, v, krel, dout = _inputs(K, B, h, S, dk, 5 * S + dk)
    seed = torch.tensor([3], dtype=torch.int64)
    args = tuple(_t(a) for a in (q, k, v, krel))
    a64 = tuple(a.double() for a in args)
    got = ha.relpos_attention_split(*args, B, h, 0.1, seed)
    exact = ha.relpos_attention_ref(*a64, B, h, 0.1, seed)
    assert (got.double() - exact).abs().max().item() <= FWD_ATOL / 10
    grads = ha.relpos_attention_bwd_split(*args, _t(dout), B, h, 0.1, seed)
    want = ha.relpos_attention_bwd_ref(*a64, _t(dout, torch.float64), B, h,
                                       0.1, seed)
    for name, g, e in zip(("dq", "dk", "dv", "dkrel"), grads, want):
        assert _rel(g, e) <= BWD_REL / 10, (name, _rel(g, e))


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_split_error_stays_a_fraction_of_the_tolerance(rate):
    """Why six split products in the forward and three in the backward,
    K5's choice: at S 116, dk 64 the forward's six stay within a hundredth
    of the float32 forward tolerance, ten times under three's, which use
    over half of the tenth the kernels aim at; the backward's three stay
    within a tenth of its tolerance, where six would reach a hundredth."""
    q, k, v, krel, dout = _inputs(2, 2, 2, 116, 64, 5)
    seed = torch.tensor([3], dtype=torch.int64)
    args = tuple(_t(a) for a in (q, k, v, krel))
    a64 = tuple(a.double() for a in args)
    exact = ha.relpos_attention_ref(*a64, 2, 2, rate, seed)
    six = (ha.relpos_attention_split(*args, 2, 2, rate, seed).double()
           - exact).abs().max().item()
    three = (ha.relpos_attention_split(*args, 2, 2, rate, seed, products=3)
             .double() - exact).abs().max().item()
    assert six <= FWD_ATOL / 100, six
    assert six < three / 10 and three > FWD_ATOL / 20, (six, three)
    want = ha.relpos_attention_bwd_ref(*a64, _t(dout, torch.float64), 2, 2,
                                       rate, seed)
    for products, limit in ((3, BWD_REL / 10), (6, BWD_REL / 100)):
        got = ha.relpos_attention_bwd_split(*args, _t(dout), 2, 2, rate,
                                            seed, products=products)
        worst = max(_rel(g, e) for g, e in zip(got, want))
        assert worst <= limit, (products, worst)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("K,B,h,S,dk", SHAPES[:4] + CLUSTER_SHAPES)
def test_bf16_split_matches_the_bf16_plain_versions(K, B, h, S, dk, rate):
    """The bf16 arithmetic (one bf16 product each; the normalised p r, ds
    and, in the backward, p r rounded to bf16 as the JAX kernel casts
    them, the forward's rows' max and sum found by a first walk) against
    the bf16 plain versions within chip_smoke's bf16 tolerances."""
    q, k, v, krel, dout = _inputs(K, B, h, S, dk, 7 * S + dk)
    seed = torch.tensor([3], dtype=torch.int64)
    bf = torch.bfloat16
    args = tuple(_t(a, bf) for a in (q, k, v, krel))
    got = ha.relpos_attention_split(*args, B, h, rate, seed)
    want = ha.relpos_attention_ref(*args, B, h, rate, seed)
    assert got.dtype == bf
    torch.testing.assert_close(got.float(), want.float(), **BF16_FWD)
    grads = ha.relpos_attention_bwd_split(*args, _t(dout, bf), B, h, rate,
                                          seed)
    wants = ha.relpos_attention_bwd_ref(*args, _t(dout, bf), B, h, rate,
                                        seed)
    for name, g, e in zip(("dq", "dk", "dv", "dkrel"), grads, wants):
        assert g.dtype == e.dtype, name
        assert _rel(g.float(), e.float()) <= BF16_BWD_REL, name


@pytest.mark.parametrize("S,T", [(7, 64), (65, 64), (116, 32), (244, 64)])
def test_windows_hold_the_skewed_columns(S, T):
    """Tile pair (qt, kt)'s window, read at column (j - j0) - (i - i0) + T
    - 1, is krel[:, j - i + S - 1] at every causal pair, and zero where
    that column is outside [0, S); window qt - kt starts at krel column
    S - (qt - kt + 1) T."""
    dk = 3
    krel = torch.randn(1, dk, S)
    n = -(-S // T)
    for qt in range(n):
        for kt in range(qt + 1):
            i0, j0 = qt * T, kt * T
            win = ha.krel_window(krel, S, i0, j0, T)
            assert win.shape == (1, dk, 2 * T)
            for i in range(i0, min(i0 + T, S)):
                for j in range(j0, min(j0 + T, i + 1)):
                    c = (j - j0) - (i - i0) + T - 1
                    assert torch.equal(win[0, :, c], krel[0, :, j - i + S - 1])
            start = S - (qt - kt + 1) * T
            for c in range(2 * T):
                if not 0 <= start + c < S:
                    assert not win[0, :, c].any()


# the (S, dk) of K2 on chip_smoke's train paths and kernel phase: the
# default, --sizeWindow 40960 --hiddenEncoder 512, 768, 200, 1056,
# --sizeWindow 163840, 2048 and 4096, and the long-window case at dk 264
CHIP_SHAPES = [(116, 32), (244, 64), (116, 96), (116, 25), (116, 132),
               (1012, 32), (116, 256), (116, 512), (3700, 264)]


def test_bodies_by_shape():
    """The tensor-core body at every shape chip_smoke runs and every
    S <= 4096, dk <= 512, in both dtypes; the cluster body at dk 513-4096
    (--hiddenEncoder 4104-32768), to S 4096 too, and past dk 4096 (more
    than the 8 CTAs of a portable cluster) `supported` refuses; the tiles
    are K5's (64 rows, 32 past 128 bf16 planes' values a row, 16 past dk
    256, the cluster body's too)."""
    for dt in (torch.float32, torch.bfloat16):
        for S, dk in CHIP_SHAPES + [(1, 1), (1024, 256), (7, 33), (65, 16),
                                    (2048, 32), (4084, 32), (4096, 256),
                                    (116, 257), (116, 264), (4096, 512)]:
            assert ha.fwd_body(S, dk, dt) == ha.bwd_body(S, dk, dt) == "tc"
        for dk in (513, 520, 1024, 4096):
            assert ha.supported(116, dk) is None
            assert ha.fwd_body(116, dk, dt) == ha.bwd_body(116, dk, dt) \
                == "cluster"
        assert ha.tile_rows(520, dt) == ha.tile_rows(4096, dt, True) == 16
    assert ha.supported(1024, 4096) is None
    assert ha.supported(4096, 4096) is None
    assert ha.fwd_body(3700, 520, torch.float32) == "cluster"
    assert ha.supported(4097, 32) is not None
    assert "dk <= 4096" in ha.supported(116, 4097)
    assert ha.BODY_CODES == {"tc": 1, "cluster": 2}
    f32, bf = torch.float32, torch.bfloat16
    assert ha.tile_rows(32, f32) == ha.tile_rows(128, bf) == 64
    assert ha.tile_rows(64, f32) == ha.tile_rows(256, bf) == 32
    assert ha.tile_rows(64, f32, backward=True) == 64
    assert ha.tile_rows(96, f32, backward=True) == 32
    assert ha.tile_rows(512, f32) == ha.tile_rows(512, bf) \
        == ha.tile_rows(264, f32, backward=True) == 16
