"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Every test here needs a CUDA device and skips without one.  The file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(``--noconftest``: tests/conftest.py sets up JAX).  chip_smoke.py repeats
the comparison at the train paths' own shapes.
"""

import itertools

import numpy as np
import pytest
import torch

from cpc_audio_tpu_torch.ops import (attention_block, causal_attention,
                                     conv_ln, dropout, ffn, gru,
                                     head_attention, lstm, scatter_add)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _rand(rng, dev, dtype, *shape, scale=1.0, shift=0.0):
    a = rng.randn(*shape) * scale + shift
    return torch.from_numpy(a.astype(np.float32)).to(dev, dtype)


# float32: sums in another order; bf16: one or two output ulps
TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
       torch.bfloat16: dict(atol=1e-2, rtol=2e-2)}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,T,H", [(3, 9, 32), (2, 5, 40)])
def test_lstm_kernel(dev, dtype, B, T, H):
    """H = 40: 160 gate rows, 5 tiles of 32 over the block's warps, and
    lanes past H / 4 idle."""
    rng = np.random.RandomState(H)
    args = (_rand(rng, dev, dtype, B, T, 4 * H),
            _rand(rng, dev, dtype, 4 * H, H, scale=0.2),
            _rand(rng, dev, dtype, B, H), _rand(rng, dev, dtype, B, H))
    before = lstm.lstm_fwd.launches
    got = lstm.lstm_fwd(*args)
    assert lstm.lstm_fwd.launches == before + 1
    for g, w in zip(got, lstm.lstm_scan_ref(*args)):
        torch.testing.assert_close(g, w, **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S,dk", [(116, 32), (20, 16), (116, 25), (20, 33),
                                  (116, 132), (20, 256)])
def test_relpos_attention_kernel(dev, dtype, S, dk):
    """dk 25 and 33 (--hiddenEncoder 200 and 264): no multiple of 8,
    copied to aligned planes first; dk 132 and 256 (--hiddenEncoder 1056
    and 2048): padded to DKP 256, tiles of 32 rows."""
    rng = np.random.RandomState(S)
    K, B, h = 2, 3, 2
    args = [_rand(rng, dev, dtype, K, B * S, h * dk) for _ in range(3)]
    args.append(_rand(rng, dev, dtype, K, dk, S, scale=0.5))
    before = head_attention.relpos_attention.launches
    got = head_attention.relpos_attention(*args, B, h)
    assert head_attention.relpos_attention.launches == before + 1
    torch.testing.assert_close(
        got, head_attention.relpos_attention_ref(*args, B, h), **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M,D,F", [(40, 64, 128), (64, 256, 256),
                                   (33, 32, 64), (70, 512, 2048),
                                   (40, 384, 2048), (21, 1024, 2048),
                                   (29, 768, 2048), (40, 200, 2048),
                                   (29, 40, 128), (35, 1056, 2048),
                                   (21, 2048, 128)])
def test_layer_tail_kernel(dev, dtype, M, D, F):
    """The forward's launches (LN1, G1 on 128 x 128 tiles, G2 on a row
    tile of all D columns; in float32 after the weights' split): M = 40,
    33, 29 and 21 ragged row tiles (128 rows in G1; 128, 64 or 32 in G2);
    D = 32: G2's narrowest row, 224 of its 256 columns idle; D = 64, F =
    128: G1's one column tile; D = 512 (--hiddenEncoder 512): 64 x 512
    row tiles; D = 384: the same, 128 columns idle; D = 1024: 32 x 1024
    row tiles 16 deep; D = 768: the same, 256 columns idle; D = 200 and
    40: no multiple of 32, the 8-column chunks past D zero-filled; D =
    1056 and 2048: the wide body (G2 on 128 x 128 tiles, LN2 in a row
    pass).  Reruns are bit-identical (no atomics, fixed-order sums)."""
    rng = np.random.RandomState(M + D)
    K = 2
    f32 = torch.float32
    args = (_rand(rng, dev, dtype, K, M, D),
            _rand(rng, dev, f32, K, D, scale=0.1, shift=1.0),
            _rand(rng, dev, f32, K, D, scale=0.1),
            _rand(rng, dev, dtype, K, D, F, scale=D ** -0.5),
            _rand(rng, dev, f32, K, F, scale=0.1),
            _rand(rng, dev, dtype, K, F, D, scale=F ** -0.5),
            _rand(rng, dev, f32, K, D, scale=0.1),
            _rand(rng, dev, f32, K, D, scale=0.1, shift=1.0),
            _rand(rng, dev, f32, K, D, scale=0.1))
    before = ffn.layer_tail.launches
    got = ffn.layer_tail(*args)
    assert ffn.layer_tail.launches == before + 1
    torch.testing.assert_close(got, ffn.layer_tail_ref(*args), **TOL[dtype])
    assert torch.equal(ffn.layer_tail(*args), got)


def test_wrappers_reject_what_kernels_do_not_take(dev):
    x = torch.zeros(2, 4, 16, device=dev)
    with pytest.raises(ValueError, match="dtype"):
        lstm.lstm_fwd(x.half(), torch.zeros(16, 4, device=dev).half(),
                      torch.zeros(2, 4, device=dev).half(),
                      torch.zeros(2, 4, device=dev).half())
    with pytest.raises(ValueError, match="several devices"):
        lstm.lstm_fwd(x, torch.zeros(16, 4), torch.zeros(2, 4, device=dev),
                      torch.zeros(2, 4, device=dev))
    q = torch.zeros(1, 8, 16, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        head_attention.relpos_attention(q, q, q.transpose(1, 2).contiguous()
                                        .transpose(1, 2),
                                        torch.zeros(1, 8, 8, device=dev), 1, 2)
    w = torch.zeros(1, 32, 40, device=dev, dtype=torch.bfloat16)
    v = torch.zeros(1, 32, device=dev)
    with pytest.raises(ValueError, match="multiple of 64"):
        ffn.layer_tail(torch.zeros(1, 8, 32, device=dev, dtype=torch.bfloat16),
                       v, v, w, torch.zeros(1, 40, device=dev),
                       w.transpose(1, 2).contiguous(), v, v, v)


# ---- backward kernels and dropout ---------------------------------------------

# Backward: float32 sums in another order (and, in bf16, the rounding of
# ds / df / dhp to bf16 flipping by one ulp where the orders differ), so
# the error is bounded relative to the largest entry of the reference.
BWD_REL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# chip_smoke.py's TOLERANCE for K5's backward, on the 2-norm of each
# gradient
BWD_NORM = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
RATES = [0.0, 0.1]


def _close(got, want, rel, name):
    assert got.shape == want.shape and got.dtype == want.dtype, name
    err = (got.float() - want.float()).abs().max().item()
    bound = rel * want.float().abs().max().item() + 1e-6
    assert err <= bound, f"{name}: max abs err {err:.3e} > {bound:.3e}"


def _seed(dev):
    return torch.tensor([12345], dtype=torch.int64, device=dev)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,T,H", [(3, 9, 32), (2, 5, 40)])
def test_lstm_bwd_kernel(dev, dtype, B, T, H):
    """The saved residuals of the forward kernel and the reverse scan
    against the plain versions; H = 40: column pairs that do not fill the
    block's thread groups evenly."""
    rng = np.random.RandomState(H + 1)
    args = (_rand(rng, dev, dtype, B, T, 4 * H),
            _rand(rng, dev, dtype, 4 * H, H, scale=0.2),
            _rand(rng, dev, dtype, B, H), _rand(rng, dev, dtype, B, H))
    got = lstm.lstm_fwd(*args, save_residuals=True)
    want = lstm.lstm_scan_ref(*args, save_residuals=True)
    for g, w in zip(got[3:], want[3:]):
        torch.testing.assert_close(g, w, **TOL[torch.float32])
    gates, cs = want[3:]
    dys = _rand(rng, dev, dtype, B, T, H)
    dhT, dcT = (_rand(rng, dev, torch.float32, B, H) for _ in range(2))
    bargs = (gates, cs, args[3], dys, args[1], dhT, dcT)
    before = lstm.lstm_bwd.launches
    got = lstm.lstm_bwd(*bargs)
    assert lstm.lstm_bwd.launches == before + 1
    for name, g, w in zip(("dgates", "dh0", "dc0"), got,
                          lstm.lstm_bwd_ref(*bargs)):
        _close(g, w, BWD_REL[torch.float32], name)


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S,dk", [(116, 32), (20, 16), (116, 64), (244, 32),
                                  (244, 64), (116, 25), (116, 132),
                                  (1012, 32), (1024, 256)])
def test_relpos_attention_bwd_kernel(dev, dtype, S, dk, rate):
    """Forward at the rate, then the backward, each against its plain
    version with the same seed: at rate 0.1 a mask that differed between
    the kernel and dropout.py would fail both.  (116, 64) is the heads of
    --hiddenEncoder 512, (244, 32) those of --sizeWindow 40960, (244, 64)
    those of both flags, (116, 25) and (116, 132) those of
    --hiddenEncoder 200 and 1056, (1012, 32) those of --sizeWindow 163840
    and (1024, 256) the longest S the gate takes at the widest head of the
    tensor-core body."""
    rng = np.random.RandomState(S + dk)
    K, B, h = 2, 3, 2
    args = [_rand(rng, dev, dtype, K, B * S, h * dk) for _ in range(3)]
    args.append(_rand(rng, dev, dtype, K, dk, S, scale=0.5))
    seed = _seed(dev)
    torch.testing.assert_close(
        head_attention.relpos_attention_fwd(*args, B, h, rate, seed),
        head_attention.relpos_attention_ref(*args, B, h, rate, seed),
        **TOL[dtype])
    dout = _rand(rng, dev, dtype, K, B * S, h * dk)
    before = head_attention.relpos_attention_bwd.launches
    got = head_attention.relpos_attention_bwd(*args, dout, B, h, rate, seed)
    assert head_attention.relpos_attention_bwd.launches == before + 1
    want = head_attention.relpos_attention_bwd_ref(*args, dout, B, h, rate,
                                                   seed)
    for name, g, w in zip(("dq", "dk", "dv", "dkrel"), got, want):
        _close(g, w, BWD_REL[dtype], name)


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dk", [25, 32, 64, 96, 132, 256, 264, 512])
@pytest.mark.parametrize("S", [1, 7, 116, 244, 1012, 1024])
def test_relpos_attention_tc_body(dev, S, dk, dtype, rate):
    """The tensor-core body (csrc/relpos_attention_tc_*.cu) at every S up
    to 1024 it takes, down to one row and a ragged tile, and every dk
    class (25: copied to aligned planes; 96, 132: padded to DKP 128, 256;
    264, 512: DKP 512, 16-row tiles, each warp's quarter of dk summed):
    forward and backward against the plain versions, on K 2 x B 3 x h 2
    heads of several query tiles, each call under its body's count and
    bit-identical when run again."""
    rng = np.random.RandomState(S * 7 + dk)
    K, B, h = 2, 3, 2
    args = [_rand(rng, dev, dtype, K, B * S, h * dk) for _ in range(3)]
    args.append(_rand(rng, dev, dtype, K, dk, S, scale=0.5))
    dout = _rand(rng, dev, dtype, K, B * S, h * dk, scale=0.1)
    seed = _seed(dev)
    assert head_attention.fwd_body(S, dk, dtype) == "tc"
    assert head_attention.bwd_body(S, dk, dtype) == "tc"
    fwd_before = head_attention.relpos_attention.body_launches["tc"]
    bwd_before = head_attention.relpos_attention_bwd.body_launches["tc"]
    got = head_attention.relpos_attention_fwd(*args, B, h, rate, seed)
    torch.testing.assert_close(
        got, head_attention.relpos_attention_ref(*args, B, h, rate, seed),
        **TOL[dtype])
    grads = head_attention.relpos_attention_bwd(*args, dout, B, h, rate,
                                                seed)
    want = head_attention.relpos_attention_bwd_ref(*args, dout, B, h, rate,
                                                   seed)
    for name, g, w in zip(("dq", "dk", "dv", "dkrel"), grads, want):
        _close(g, w, BWD_REL[dtype], name)
    assert torch.equal(
        head_attention.relpos_attention_fwd(*args, B, h, rate, seed), got)
    again = head_attention.relpos_attention_bwd(*args, dout, B, h, rate,
                                                seed)
    for name, g, a in zip(("dq", "dk", "dv", "dkrel"), grads, again):
        assert torch.equal(g, a), name
    torch.cuda.synchronize()
    assert head_attention.relpos_attention.body_launches["tc"] == \
        fwd_before + 2
    assert head_attention.relpos_attention_bwd.body_launches["tc"] == \
        bwd_before + 2


@pytest.mark.parametrize("dtype", DTYPES)
def test_relpos_attention_bodies_mirror_the_kernels(dev, dtype):
    """The pure choice of body (ops/head_attention.py fwd_body / bwd_body,
    no card needed) is the C library's (cpc_relpos_attention_{fwd,bwd}_body),
    which refuses past dk 4096 and S 4096; past dk 512 the cluster body
    runs, against the plain versions, at S 20 (two 16-row tiles, the
    second ragged)."""
    from cpc_audio_tpu_torch.ops import _build
    lib, code = _build.library(), _build.DTYPE_CODES[dtype]
    codes = head_attention.BODY_CODES
    for S in (1, 7, 116, 244, 1012, 1024, 2048, 3700, 4084, 4096):
        for dk in (1, 25, 32, 64, 96, 132, 256, 257, 264, 512, 513, 520,
                   1024, 4096):
            assert lib.cpc_relpos_attention_fwd_body(S, dk, code) == \
                codes[head_attention.fwd_body(S, dk, dtype)], (S, dk)
            assert lib.cpc_relpos_attention_bwd_body(S, dk, code) == \
                codes[head_attention.bwd_body(S, dk, dtype)], (S, dk)
    for S, dk in ((116, 4097), (4097, 32)):
        assert head_attention.supported(S, dk) is not None
        assert lib.cpc_relpos_attention_fwd_body(S, dk, code) == 0
        assert lib.cpc_relpos_attention_bwd_body(S, dk, code) == 0
    S, dk, K, B, h = 20, 520, 2, 3, 2
    assert head_attention.fwd_body(S, dk, dtype) == "cluster"
    rng = np.random.RandomState(11)
    args = [_rand(rng, dev, dtype, K, B * S, h * dk) for _ in range(3)]
    args.append(_rand(rng, dev, dtype, K, dk, S, scale=0.5))
    dout = _rand(rng, dev, dtype, K, B * S, h * dk, scale=0.1)
    seed = _seed(dev)
    count = (head_attention.relpos_attention.body_launches["cluster"],
             head_attention.relpos_attention_bwd.body_launches["cluster"])
    torch.testing.assert_close(
        head_attention.relpos_attention_fwd(*args, B, h, 0.1, seed),
        head_attention.relpos_attention_ref(*args, B, h, 0.1, seed),
        **TOL[dtype])
    got = head_attention.relpos_attention_bwd(*args, dout, B, h, 0.1, seed)
    want = head_attention.relpos_attention_bwd_ref(*args, dout, B, h, 0.1,
                                                   seed)
    for name, g, w in zip(("dq", "dk", "dv", "dkrel"), got, want):
        _close(g, w, BWD_REL[dtype], name)
    assert (head_attention.relpos_attention.body_launches["cluster"],
            head_attention.relpos_attention_bwd.body_launches["cluster"]) \
        == (count[0] + 1, count[1] + 1)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S,dk,K,B,h", [(2048, 32, 2, 1, 8),
                                        (4084, 32, 1, 1, 8),
                                        (3700, 264, 1, 1, 2),
                                        (3700, 520, 1, 1, 2),
                                        (4096, 1024, 1, 1, 1)])
def test_relpos_attention_long_windows(dev, dtype, S, dk, K, B, h):
    """K2 past the S 1024 it once stopped at, at rate 0.1 (the train
    step's): the tensor-core body at S 2048 and at the heads' S 4084 of
    --sizeWindow 655360 (dk 32) and at S 3700, dk 264 (DKP 512), and the
    cluster body at S 3700, dk 520 (232 query tiles of two CTAs) and at S
    4096, dk 1024:
    forward and backward against the plain versions (on fewer heads than
    the train step's, for the plain version's (S, S) tiles), each call
    under its body's count, a rerun bit-identical."""
    rng = np.random.RandomState(S + dk)
    args = [_rand(rng, dev, dtype, K, B * S, h * dk) for _ in range(3)]
    args.append(_rand(rng, dev, dtype, K, dk, S, scale=0.5))
    dout = _rand(rng, dev, dtype, K, B * S, h * dk, scale=0.1)
    seed = _seed(dev)
    body = head_attention.fwd_body(S, dk, dtype)
    assert body == head_attention.bwd_body(S, dk, dtype) == (
        "tc" if dk <= 512 else "cluster")
    before = (head_attention.relpos_attention.body_launches[body],
              head_attention.relpos_attention_bwd.body_launches[body])
    got = head_attention.relpos_attention_fwd(*args, B, h, 0.1, seed)
    torch.testing.assert_close(
        got, head_attention.relpos_attention_ref(*args, B, h, 0.1, seed),
        **TOL[dtype])
    grads = head_attention.relpos_attention_bwd(*args, dout, B, h, 0.1,
                                                seed)
    want = head_attention.relpos_attention_bwd_ref(*args, dout, B, h, 0.1,
                                                   seed)
    for name, g, w in zip(("dq", "dk", "dv", "dkrel"), grads, want):
        _close(g, w, BWD_REL[dtype], name)
    del want
    again = head_attention.relpos_attention_bwd(*args, dout, B, h, 0.1,
                                                seed)
    for name, g, a in zip(("dq", "dk", "dv", "dkrel"), grads, again):
        assert torch.equal(g, a), name
    torch.cuda.synchronize()
    assert (head_attention.relpos_attention.body_launches[body],
            head_attention.relpos_attention_bwd.body_launches[body]) == (
        before[0] + 1, before[1] + 2)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S,dk,K,B,h", [(116, 520, 2, 3, 2),
                                        (116, 1024, 2, 2, 2),
                                        (20, 1024, 1, 2, 3),
                                        (33, 2056, 1, 1, 2),
                                        (20, 4096, 1, 1, 1)])
def test_relpos_attention_cluster_body(dev, dtype, S, dk, K, B, h):
    """The cluster body past dk 512 at rate 0.1: dk 520 (--hiddenEncoder
    4160's heads at S 116: two CTAs, the second's 8 columns on one warp),
    1024 (two whole slabs), 2056 (five CTAs, the last of 8 columns; S 33
    ends in a ragged tile) and 4096 (eight CTAs, the widest cluster the
    gate takes), forward and backward against the plain
    versions, each call under the "cluster" count, and a rerun of both
    bit-identical (the cluster's sums go in a fixed order)."""
    rng = np.random.RandomState(S + dk + K)
    args = [_rand(rng, dev, dtype, K, B * S, h * dk) for _ in range(3)]
    args.append(_rand(rng, dev, dtype, K, dk, S, scale=0.5))
    dout = _rand(rng, dev, dtype, K, B * S, h * dk, scale=0.1)
    seed = _seed(dev)
    assert head_attention.fwd_body(S, dk, dtype) == "cluster"
    before = (head_attention.relpos_attention.body_launches["cluster"],
              head_attention.relpos_attention_bwd.body_launches["cluster"])
    out = head_attention.relpos_attention_fwd(*args, B, h, 0.1, seed)
    torch.testing.assert_close(
        out, head_attention.relpos_attention_ref(*args, B, h, 0.1, seed),
        **TOL[dtype])
    grads = head_attention.relpos_attention_bwd(*args, dout, B, h, 0.1,
                                                seed)
    want = head_attention.relpos_attention_bwd_ref(*args, dout, B, h, 0.1,
                                                   seed)
    for name, g, w in zip(("dq", "dk", "dv", "dkrel"), grads, want):
        _close(g, w, BWD_REL[dtype], name)
    assert torch.equal(out, head_attention.relpos_attention_fwd(
        *args, B, h, 0.1, seed))
    again = head_attention.relpos_attention_bwd(*args, dout, B, h, 0.1,
                                                seed)
    for name, g, a in zip(("dq", "dk", "dv", "dkrel"), grads, again):
        assert torch.equal(g, a), name
    torch.cuda.synchronize()
    assert (head_attention.relpos_attention.body_launches["cluster"],
            head_attention.relpos_attention_bwd.body_launches["cluster"]) \
        == (before[0] + 2, before[1] + 2)


def _tail_args(rng, dev, dtype, K, M, D, F):
    f32 = torch.float32
    return (_rand(rng, dev, dtype, K, M, D),
            _rand(rng, dev, f32, K, D, scale=0.1, shift=1.0),
            _rand(rng, dev, f32, K, D, scale=0.1),
            _rand(rng, dev, dtype, K, D, F, scale=D ** -0.5),
            _rand(rng, dev, f32, K, F, scale=0.1),
            _rand(rng, dev, dtype, K, F, D, scale=F ** -0.5),
            _rand(rng, dev, f32, K, D, scale=0.1),
            _rand(rng, dev, f32, K, D, scale=0.1, shift=1.0),
            _rand(rng, dev, f32, K, D, scale=0.1))


# One head of the train step's K3 shapes: over millions of hidden units a
# few lie within rounding of the ReLU kink and take the other branch in
# one version, moving one row's whole contribution to dW1 and dx, so each
# gradient is held by its 2-norm, at chip_smoke.py's TOLERANCE for K3's
# backward in its dtype.  In float32 against the exact plain version
# (float64 throughout), so that the plain version's own float32 rounding
# at the kink does not count.  With these inputs at (1952, 512, 2048) two
# units lie within float32's own rounding of the kink (exact
# pre-activations -9.3e-8 and 4.8e-8; port_perf/k3_split_accuracy.py), so
# that a float32 product in any order may take either branch, and one
# such unit moves dW1 by about 1.3e-3 of its norm at K = 2.  No float32
# version decides such a unit, so the exact version leaves it undecided
# (`_undecided_units`) and the kernel is held against the nearest of the
# exact versions with each undecided unit forced live or dead.
TAIL_TRAIN_SHAPES = [(3712, 256, 2048), (1952, 512, 2048)]
TAIL_TRAIN_NORM = {torch.float32: 1e-3, torch.bfloat16: 2e-2}
# A kept unit is undecided where its exact pre-activation y W1 + b1 lies
# within KINK_C 2^-24 (sum_d |y_d W1_df| + |b1_f|) of 0: a relative change
# of 2^-24 in every term of its sum, the bound
# tests/test_torch_split.py::test_split_product_within_its_bound holds for
# each term a product of 6 split terms drops (there `term` is three of
# them), and one float32 rounding of each term, can move it across the
# kink.  KINK_C = 1 leaves out that test's worst case of the float32 sum
# (6 D such terms), which no float32 product reaches and which would take
# in thousands of units.  These inputs hold 4 such units at (3712, 256,
# 2048) and 4 and 3 at (1952, 512, 2048), rates 0 and 0.1, the two above
# among them (port_perf/k3_split_accuracy.py).
KINK_C = 1.0
MAX_UNDECIDED = 4


def _undecided_units(args, rate, seed):
    """(n, 3) (k, row, f) of the kept hidden units whose exact (float64)
    pre-activation lies within KINK_C 2^-24 (sum_d |y_d W1_df| + |b1_f|)
    of 0."""
    x, ln1w, ln1b, w1, b1 = (a.double() for a in args[:5])
    K, M, _ = x.shape
    y = ffn._affine(ffn._ln(x, 1e-5)[0], ln1w, ln1b)
    pre = y @ w1 + b1[:, None]
    scale = y.abs() @ w1.abs() + b1.abs()[:, None]
    near = pre.abs() <= KINK_C * 2.0 ** -24 * scale
    mask = dropout.ffn_mask(seed, rate, K, M, w1.shape[-1], x.device)
    if mask is not None:
        near &= mask > 0
    return torch.nonzero(near)


TAIL_BWD_CASES = [
    pytest.param(M, D, F, dt, id=f"{M}-{D}-{F}-dtype{DTYPES.index(dt)}")
    for M, D, F in [(40, 64, 128), (33, 32, 64), (70, 256, 256),
                    (45, 512, 2048), (45, 384, 2048), (37, 1024, 2048),
                    (29, 768, 2048), (33, 200, 2048), (29, 40, 128),
                    (35, 1056, 2048), (21, 2048, 128)]
    for dt in DTYPES] + [
    pytest.param(M, D, F, torch.bfloat16, id=f"{M}-{D}-{F}-dtype1")
    for M, D, F in TAIL_TRAIN_SHAPES] + [
    pytest.param(33, 96, 96, torch.float32, id="33-96-96-dtype0")] + [
    pytest.param(M, D, F, torch.float32, id=f"{M}-{D}-{F}-dtype0")
    for M, D, F in TAIL_TRAIN_SHAPES]


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("M,D,F,dtype", TAIL_BWD_CASES)
def test_layer_tail_bwd_kernel(dev, dtype, M, D, F, rate):
    """M = 29, 33, 37, 40, 45 and 70: ragged row tiles (32 or 64 rows in
    G2/G4, 128 in the other GEMMs, and D, F narrower than a 128-wide
    tile); D = 32: the narrowest; D = 384 and 512: the wide tiles (G2/G4
    on 512 columns, past D at 384); D = 1024: the widest (G2/G4 on
    32 x 1024 tiles 16 deep); D = 768: the same tiles with 256 of their
    1024 columns idle; D = 200 and 40: no multiple of 32; D = 1056 and
    2048: the wide body (G2 and G4 on 128 x 128 tiles, LN2' and LN1' in
    row and column passes); f32 at F = 96 (D = 96): G1 and G3's last 128-wide
    column tile half past F, and the forward's last hidden chunk narrower
    than the others.  In float32 every product runs on split bf16 planes
    (3 products, G1 6).  (3712, 256, 2048) and (1952, 512, 2048) are one
    head of the train step's shapes (the default and --sizeWindow 40960
    --hiddenEncoder 512).  Reruns are bit-identical (no atomics,
    fixed-order sums)."""
    rng = np.random.RandomState(M + D + F)
    K = 2
    args = _tail_args(rng, dev, dtype, K, M, D, F)
    seed = _seed(dev)
    torch.testing.assert_close(
        ffn.layer_tail_fwd(*args, rate, 1e-5, seed),
        ffn.layer_tail_ref(*args, 1e-5, rate, seed), **TOL[dtype])
    dout = _rand(rng, dev, dtype, K, M, D)
    before = ffn.layer_tail_bwd.launches
    got = ffn.layer_tail_bwd(*args, dout, rate, 1e-5, seed)
    assert ffn.layer_tail_bwd.launches == before + 1
    exact = dtype == torch.float32 and (M, D, F) in TAIL_TRAIN_SHAPES
    names = ("dx", "dln1w", "dln1b", "dw1", "db1", "dw2", "db2", "dln2w",
             "dln2b")
    if exact:
        units = _undecided_units(args, rate, seed)
        assert len(units) <= MAX_UNDECIDED, units.tolist()
        wants = (ffn.layer_tail_bwd_ref(
            *[a.double() for a in args], dout.double(), 1e-5, rate, seed,
            force_live=(units, torch.tensor(live, device=dev)))
            for live in itertools.product((False, True), repeat=len(units)))
        want = min(wants, key=lambda w: max(
            _rel_norm(g, wi) for g, wi in zip(got, w)))
    else:
        want = ffn.layer_tail_bwd_ref(*args, dout, 1e-5, rate, seed)
    for name, g, w in zip(names, got, want):
        if (M, D, F) in TAIL_TRAIN_SHAPES:
            err = _rel_norm(g, w)
            assert err <= TAIL_TRAIN_NORM[dtype], f"{name}: {err:.3e}"
        else:
            _close(g, w, BWD_REL[dtype], name)
    again = ffn.layer_tail_bwd(*args, dout, rate, 1e-5, seed)
    for name, g, a in zip(names, got, again):
        assert torch.equal(g, a), name


def test_backward_wrappers_reject_what_kernels_do_not_take(dev):
    f16 = torch.float16
    z = torch.zeros(2, 3, 16, device=dev, dtype=f16)
    with pytest.raises(ValueError, match="dtype"):
        lstm.lstm_bwd(torch.zeros(2, 3, 64, device=dev),
                      torch.zeros(2, 3, 16, device=dev),
                      torch.zeros(2, 16, device=dev, dtype=f16), z,
                      torch.zeros(64, 16, device=dev, dtype=f16),
                      torch.zeros(2, 16, device=dev),
                      torch.zeros(2, 16, device=dev))
    S, dk = 4100, 64         # past K2's range, S <= 4096
    q = torch.zeros(1, S, dk, device=dev)
    with pytest.raises(ValueError, match="out of range"):
        head_attention.relpos_attention_bwd(
            q, q, q, torch.zeros(1, dk, S, device=dev), q, 1, 1)
    with pytest.raises(ValueError, match="needs a seed"):
        head_attention.relpos_attention_bwd(
            q, q, q, torch.zeros(1, dk, S, device=dev), q, 1, 1, 0.1)
    bf = torch.bfloat16
    x = torch.zeros(1, 8, 32, device=dev, dtype=bf)
    v = torch.zeros(1, 32, device=dev)
    w1 = torch.zeros(1, 32, 96, device=dev, dtype=bf)
    with pytest.raises(ValueError, match="F=96"):
        ffn.layer_tail_bwd(x, v, v, w1, torch.zeros(1, 96, device=dev),
                           w1.transpose(1, 2).contiguous(), v, v, v, x)


# ---- K4 (GRU) and K5 (causal attention with a dense bias) -------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,T,H", [(3, 9, 32), (2, 5, 64)])
def test_gru_kernels(dev, dtype, B, T, H):
    """The forward with its saved residuals, then the reverse scan, each
    against its plain version; H = 32: 3 row tiles over the block's warps
    and column pairs that leave most thread groups idle."""
    rng = np.random.RandomState(H + T)
    args = (_rand(rng, dev, dtype, B, T, 3 * H),
            _rand(rng, dev, dtype, 3 * H, H, scale=0.2),
            _rand(rng, dev, dtype, 3 * H, scale=0.1),
            _rand(rng, dev, dtype, B, H))
    before = gru.gru_fwd.launches
    got = gru.gru_fwd(*args, save_residuals=True)
    assert gru.gru_fwd.launches == before + 1
    want = gru.gru_scan_ref(*args, save_residuals=True)
    for g, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(g, w, **TOL[dtype])
    for g, w in zip(got[2:], want[2:]):
        torch.testing.assert_close(g, w, **TOL[torch.float32])
    ys, _, gates, ghn = want
    dys = _rand(rng, dev, dtype, B, T, H)
    dhT = _rand(rng, dev, torch.float32, B, H)
    bargs = (gates, ghn, args[3], ys, dys, args[1], dhT)
    before = gru.gru_bwd.launches
    got = gru.gru_bwd(*bargs)
    assert gru.gru_bwd.launches == before + 1
    for name, g, w in zip(("dx", "dghn", "dh0"), got, gru.gru_bwd_ref(*bargs)):
        _close(g, w, BWD_REL[torch.float32], name)


@pytest.mark.parametrize("dtype,H", [(torch.float32, 32), (torch.float32, 64),
                                     (torch.float32, 96),
                                     (torch.bfloat16, 32),
                                     (torch.bfloat16, 64),
                                     (torch.bfloat16, 96),
                                     (torch.bfloat16, 160)])
def test_gru_resident_body(dev, dtype, H):
    """K4's resident forward (W_hh in registers, one __syncthreads a step)
    at every width it takes, at the learning gate's B 8, T 32, from a
    non-zero h0: without residuals (the eval path) and with them (ys, hT,
    the gates and ghn), against the plain version, each call under the
    "resident" count; the two calls give the same ys and hT bits."""
    assert gru.fwd_body(H, dtype) == "resident"
    B, T = 8, 32
    rng = np.random.RandomState(H)
    args = (_rand(rng, dev, dtype, B, T, 3 * H),
            _rand(rng, dev, dtype, 3 * H, H, scale=H ** -0.5),
            _rand(rng, dev, dtype, 3 * H, scale=0.1),
            _rand(rng, dev, dtype, B, H, scale=0.5))
    before = gru.gru_fwd.body_launches["resident"]
    plain = gru.gru_fwd(*args)
    saved = gru.gru_fwd(*args, save_residuals=True)
    assert gru.gru_fwd.body_launches["resident"] == before + 2
    want = gru.gru_scan_ref(*args, save_residuals=True)
    for g, w in zip(saved[:2], want[:2]):
        torch.testing.assert_close(g, w, **TOL[dtype])
    for g, w in zip(saved[2:], want[2:]):
        torch.testing.assert_close(g, w, **TOL[torch.float32])
    for g, w in zip(plain, saved[:2]):
        assert torch.equal(g, w)


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("N,S,dk", [(8, 20, 16), (4, 116, 32), (2, 128, 32),
                                    (3, 128, 64), (2, 256, 64), (2, 72, 128),
                                    (2, 100, 40), (2, 64, 256), (2, 300, 200),
                                    (1, 1024, 256), (2, 1012, 32),
                                    (2, 4096, 32), (2, 128, 512),
                                    (2, 100, 264), (1, 2000, 512)])
def test_causal_attention_kernels(dev, dtype, N, S, dk, rate):
    """Forward and backward against the plain versions with the same seed
    and layer (the backward also at chip_smoke's tolerance on each
    gradient's 2-norm): the train shape (S 128, dk 32), the
    --hiddenGar 512 one (dk 64), S = 256 (--sizeWindow 40960, four
    64-key tiles, no tile resident between the row kernel's passes),
    ragged S (116, 100, 72, 20: tiles past S and unaligned bias rows), dk
    padded to 32, 64, 128 or 256 (16, 40, 200), the 32-row tiles of dk
    128 in float32 and of dk 256 (--hiddenEncoder 2048) and S 1024 and
    1012 (--sizeWindow 163840), S 4096 (--sizeWindow 655360) and the
    16-row tiles of DKP 512 (dk 512: --hiddenEncoder 4096; 264 padded to
    512, with a ragged S 100; S 2000).  dbias is exactly 0 above the
    diagonal although the bias is not, and a second run gives the same
    bits."""
    rng = np.random.RandomState(N + S + dk)
    args = [_rand(rng, dev, dtype, N, S, dk) for _ in range(3)]
    args.append(_rand(rng, dev, dtype, N, S, S, scale=0.5))
    seed = _seed(dev)
    before = causal_attention.causal_attention_fwd.launches
    out = causal_attention.causal_attention_fwd(*args, rate, seed, 1)
    torch.testing.assert_close(
        out, causal_attention.causal_attention_ref(*args, rate, seed, 1),
        **TOL[dtype])
    assert causal_attention.causal_attention_fwd.launches == before + 1
    assert torch.equal(out,
                       causal_attention.causal_attention_fwd(*args, rate,
                                                             seed, 1))
    dout = _rand(rng, dev, dtype, N, S, dk, scale=0.1)
    before = causal_attention.causal_attention_bwd.launches
    got = causal_attention.causal_attention_bwd(*args, dout, rate, seed, 1)
    assert causal_attention.causal_attention_bwd.launches == before + 1
    want = causal_attention.causal_attention_bwd_ref(*args, dout, rate, seed,
                                                     1)
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        _close(g, w, BWD_REL[dtype], name)
        err = (g.float() - w.float()).norm() / w.float().norm()
        assert err <= BWD_NORM[dtype], f"{name}: rel_norm_err {err:.3e}"
    upper = torch.ones(S, S, dtype=torch.bool, device=dev).triu(1)
    assert torch.count_nonzero(got[3][:, upper]) == 0
    again = causal_attention.causal_attention_bwd(*args, dout, rate, seed, 1)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


def test_gru_and_causal_wrappers_reject_what_kernels_do_not_take(dev):
    x = torch.zeros(2, 3, 120, device=dev)
    with pytest.raises(ValueError, match="H % 32"):
        gru.gru_fwd(x, torch.zeros(120, 40, device=dev),
                    torch.zeros(120, device=dev),
                    torch.zeros(2, 40, device=dev))
    for S, dk, why in ((4100, 32, "sequence length"),   # S <= 4096
                       (16, 520, "head width")):        # dk <= 512
        q = torch.zeros(1, S, dk, device=dev)
        b = torch.zeros(1, S, S, device=dev)
        with pytest.raises(ValueError, match=why):
            causal_attention.causal_attention_bwd(q, q, q, b, q)
    b = torch.zeros(1, 16, 16, device=dev)
    q = torch.zeros(1, 16, 12, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8"):
        causal_attention.causal_attention_fwd(q, q, q, b.bfloat16())
    q = torch.zeros(1, 16, 16, device=dev)
    with pytest.raises(ValueError, match="expected torch.float32"):
        causal_attention.causal_attention_fwd(q, q, q, b.half())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ["LSTM", "GRU"])
def test_recurrence_at_h100_pads_to_the_kernels(dev, dtype, mode):
    """H = 100 through the differentiable entry points: the kernels run at
    H = 104 (LSTM) or 128 (GRU) with zero units, once forward and once
    backward, and the sliced outputs and the gradients of every input
    equal autograd through the unpadded plain scan."""
    B, T, H = 3, 9, 100
    G = 4 if mode == "LSTM" else 3
    rng = np.random.RandomState(G)
    xp = _rand(rng, dev, dtype, B, T, G * H)
    w = _rand(rng, dev, dtype, G * H, H, scale=0.2)
    extra = [_rand(rng, dev, dtype, G * H, scale=0.1)] if mode == "GRU" \
        else []
    states = [_rand(rng, dev, dtype, B, H, scale=0.1)
              for _ in range(2 if mode == "LSTM" else 1)]
    ins = [xp, w] + extra + states
    mod = lstm if mode == "LSTM" else gru
    fwd, bwd = (mod.lstm_fwd, mod.lstm_bwd) if mode == "LSTM" else \
        (mod.gru_fwd, mod.gru_bwd)
    ref = mod.lstm_scan_ref if mode == "LSTM" else mod.gru_scan_ref
    a = [t.clone().requires_grad_() for t in ins]
    b = [t.clone().requires_grad_() for t in ins]
    counts = (fwd.launches, bwd.launches)
    got = (mod.lstm if mode == "LSTM" else mod.gru)(*a)
    want = ref(*b)
    cts = [_rand(rng, dev, dtype, *o.shape) for o in want]
    ga = torch.autograd.grad(got, a, cts)
    gb = torch.autograd.grad(want, b, cts)
    assert (fwd.launches, bwd.launches) == (counts[0] + 1, counts[1] + 1)
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, **TOL[dtype])
    for i, (g, w_) in enumerate(zip(ga, gb)):
        _close(g, w_, BWD_REL[dtype], f"grad {i}")


def test_python_gates_mirror_the_kernels_shared_memory(dev):
    """The pure gates (no card needed) compute the shared memory the C
    entry points report for K3's backward and K1's and K4's cluster
    bodies, and the body K1's and K4's forward and backward run."""
    from cpc_audio_tpu_torch.ops import _build
    lib = _build.library()
    for D, F in ((256, 2048), (512, 2048), (64, 128), (32, 64),
                 (384, 2048), (768, 2048), (1024, 2048), (96, 96),
                 (40, 128), (200, 2048), (1056, 2048), (2048, 128)):
        for dt in DTYPES:
            assert lib.cpc_layer_tail_bwd_smem(
                D, F, _build.DTYPE_CODES[dt]) == ffn._bwd_smem(D, F, dt)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    codes = lstm.BODY_CODES
    for H in (32, 64, 96, 104, 128, 160, 192, 256, 264, 384, 512, 768, 1024,
              1056, 2048, 4096, 6000, 8192):
        for dt in DTYPES:
            code = _build.DTYPE_CODES[dt]
            assert lib.cpc_lstm_bwd_body(H, code) == \
                codes[lstm.bwd_body(H, dt)], (H, dt)
            assert lib.cpc_lstm_fwd_body(H, code) == \
                codes[lstm.fwd_body(H, dt)], (H, dt)
            assert lib.cpc_lstm_fwd_smem(H, code) == lstm.fwd_smem(H, dt)
            assert lib.cpc_lstm_bwd_smem(H, code) == lstm.bwd_smem(H, dt)
            assert lib.cpc_gru_bwd_body(H, code) == \
                codes[gru.bwd_body(H, dt)], (H, dt)
            if H % 32 == 0:
                assert lib.cpc_gru_fwd_body(H, code) == \
                    gru.BODY_CODES[gru.fwd_body(H, dt)], (H, dt)
                assert lib.cpc_gru_fwd_smem(H, code) == gru.fwd_smem(H, dt)
            if H < lstm.GRID_MIN_H:
                continue
            for G in (3, 4):
                for back in (0, 1):
                    assert lib.cpc_rnn_grid_smem(H, G, code, back) == \
                        lstm.grid_smem(H, G, dt, sms, bool(back)), (H, G)
            for B in (3, 32, 40):
                if lstm.bwd_body(H, dt) == "grid":
                    assert lib.cpc_lstm_bwd_scratch(B, H, code) == \
                        lstm.grid_scratch(B, H, 4, dt, sms, True)
                if lstm.fwd_body(H, dt) == "grid":
                    assert lib.cpc_lstm_fwd_scratch(B, H, code) == \
                        lstm.grid_scratch(B, H, 4, dt, sms, False)
                if H % 32 == 0:
                    assert lib.cpc_gru_fwd_scratch(B, H, code) == \
                        lstm.grid_scratch(B, H, 3, dt, sms, False)
                    assert lib.cpc_gru_bwd_scratch(B, H, code) == \
                        lstm.grid_scratch(B, H, 3, dt, sms, True)


def _rel_norm(got, want):
    return ((got.float() - want.float()).norm()
            / want.float().norm().clamp_min(1e-30)).item()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ["LSTM", "GRU"])
@pytest.mark.parametrize("B,T,H", [(32, 128, 256), (3, 9, 256), (5, 7, 128),
                                   (3, 9, 512), (8, 256, 512),
                                   (32, 128, 512), (32, 128, 768),
                                   (20, 9, 768), (3, 5, 4096),
                                   (3, 5, 8192)])
def test_recurrent_bwd_bodies(dev, mode, dtype, B, T, H):
    """K1's and K4's backward at the train shape, at batches that leave a
    cluster's 16 rows part empty, at H = 128 (the cluster body's narrow
    tile) and at H = 512 and 768 (K1: the 16-CTA cluster body, at 768
    and in float32 with part of W_hh streamed, in float32 on its two bf16
    planes, also at the long-window path's B 8, T 256 and at B 32, T 128;
    K4: the grid body), and at H 4096 and 8192 (--hiddenGar 4096, 8192:
    both grid bodies, W_hh streamed every step, at 8192 in float32 in
    two pieces a column group): each
    output against its plain version within chip_smoke's 1e-4 of the
    2-norm, the body counted as the Python mirror says, and a rerun
    bit-identical."""
    rng = np.random.RandomState(B + T + H)
    G = 4 if mode == "LSTM" else 3
    mod = lstm if mode == "LSTM" else gru
    xp = _rand(rng, dev, dtype, B, T, G * H)
    w = _rand(rng, dev, dtype, G * H, H, scale=H ** -0.5)
    h0 = _rand(rng, dev, dtype, B, H, scale=0.1)
    dys = _rand(rng, dev, dtype, B, T, H, scale=0.1)
    dhT = _rand(rng, dev, torch.float32, B, H, scale=0.1)
    if mode == "LSTM":
        c0 = _rand(rng, dev, dtype, B, H, scale=0.1)
        gates, cs = lstm.lstm_scan_ref(xp, w, h0, c0,
                                       save_residuals=True)[3:]
        dcT = _rand(rng, dev, torch.float32, B, H, scale=0.1)
        args = (gates, cs, c0, dys, w, dhT, dcT)
        kernel, plain = lstm.lstm_bwd, lstm.lstm_bwd_ref
    else:
        b_hh = _rand(rng, dev, dtype, G * H, scale=0.1)
        ys, _, gates, ghn = gru.gru_scan_ref(xp, w, b_hh, h0,
                                             save_residuals=True)
        args = (gates, ghn, h0, ys, dys, w, dhT)
        kernel, plain = gru.gru_bwd, gru.gru_bwd_ref
    body = mod.bwd_body(H, dtype)
    assert body == ("cluster" if H < 512 or (mode == "LSTM" and H <= 768)
                    else "grid")
    before = dict(kernel.body_launches)
    got = kernel(*args)
    again = kernel(*args)
    torch.cuda.synchronize()
    assert kernel.body_launches[body] == before[body] + 2
    for i, (g, w_) in enumerate(zip(got, plain(*args))):
        assert g.shape == w_.shape and g.dtype == w_.dtype
        err = _rel_norm(g, w_)
        assert err <= 1e-4, f"output {i}: rel_norm_err {err:.3e}"
    for g, a in zip(got, again):
        assert torch.equal(g, a)


# K1's float32 cluster bodies against the plain forward, elementwise:
# chip_smoke's float32 K1 tolerance (3 split products drop about 2^-16 of
# |h||W_hh| a term, compounded over the steps; tests/test_torch_split.py
# puts the arithmetic at 2-5e-6 of it at these shapes)
K1_TOL = {torch.float32: dict(atol=2e-4, rtol=0.0),
          torch.bfloat16: TOL[torch.bfloat16]}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,T,H", [(8, 256, 512), (32, 128, 512),
                                   (32, 128, 768), (20, 9, 768)])
def test_lstm_cluster_bodies(dev, B, T, H, dtype):
    """K1 at H 512 and 768, forward and backward on their 16-CTA cluster
    bodies (at 768, and in float32, with part of W_hh streamed from L2;
    float32 on W_hh's two bf16 planes; B 20: the second cluster's m16
    tile holds 4 rows): every output of the forward (ys, hT, cT, gates,
    cs) against the plain forward (``K1_TOL``), the backward's within
    1e-4 of the 2-norm, each body counted, and reruns bit-identical."""
    rng = np.random.RandomState(B + T + H + 1)
    args = (_rand(rng, dev, dtype, B, T, 4 * H),
            _rand(rng, dev, dtype, 4 * H, H, scale=H ** -0.5),
            _rand(rng, dev, dtype, B, H, scale=0.1),
            _rand(rng, dev, dtype, B, H, scale=0.1))
    assert lstm.fwd_body(H, dtype) == lstm.bwd_body(H, dtype) == "cluster"
    before = (dict(lstm.lstm_fwd.body_launches),
              dict(lstm.lstm_bwd.body_launches))
    got = lstm.lstm_fwd(*args, save_residuals=True)
    again = lstm.lstm_fwd(*args, save_residuals=True)
    want = lstm.lstm_scan_ref(*args, save_residuals=True)
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        torch.testing.assert_close(g.float(), w.float(), **K1_TOL[dtype])
    gates, cs = want[3:]
    bargs = (gates, cs, args[3], _rand(rng, dev, dtype, B, T, H, scale=0.1),
             args[1], _rand(rng, dev, torch.float32, B, H, scale=0.1),
             _rand(rng, dev, torch.float32, B, H, scale=0.1))
    got = lstm.lstm_bwd(*bargs)
    again = lstm.lstm_bwd(*bargs)
    torch.cuda.synchronize()
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    for i, (g, w) in enumerate(zip(got, lstm.lstm_bwd_ref(*bargs))):
        err = _rel_norm(g, w)
        assert err <= 1e-4, f"output {i}: rel_norm_err {err:.3e}"
    assert lstm.lstm_fwd.body_launches == {
        "cluster": before[0]["cluster"] + 2, "grid": before[0]["grid"],
        "rows": before[0]["rows"]}
    assert lstm.lstm_bwd.body_launches == {
        "cluster": before[1]["cluster"] + 2, "grid": before[1]["grid"],
        "rows": before[1]["rows"]}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ["LSTM", "GRU"])
@pytest.mark.parametrize("H", [128, 256])
@pytest.mark.parametrize("B,T", [(1, 400), (3, 1), (17, 128), (32, 128)])
def test_cluster_forward_bodies(dev, mode, H, B, T, dtype):
    """K1's and K4's forward on their cluster body at H 128 (8 CTAs) and 256
    (16; the default --hiddenGar; csrc/rnn_cluster_fwd.cuh), at build_feature's
    B 1 / T 400 (15 of the cluster's 16 rows padding), B 3 at T 1 (no
    exchange at all), B 17 (a second cluster with one row) and the train
    shape: every output of the forward against its plain version
    (float32: ``lstm_scan_split`` / ``gru_scan_split``, the body's 3 split
    products; bf16: the plain forward) within ``K1_TOL``, reruns
    bit-identical, the eval call (no residuals) giving the same ys and
    final state bit for bit, and each launch counted on the cluster
    body."""
    rng = np.random.RandomState(B + T + H + 3)
    G = 4 if mode == "LSTM" else 3
    mod = lstm if mode == "LSTM" else gru
    xp = _rand(rng, dev, dtype, B, T, G * H)
    w = _rand(rng, dev, dtype, G * H, H, scale=H ** -0.5)
    h0 = _rand(rng, dev, dtype, B, H, scale=0.1)
    if mode == "LSTM":
        args = (xp, w, h0, _rand(rng, dev, dtype, B, H, scale=0.1))
        fwd = lstm.lstm_fwd
        plain = lstm.lstm_scan_split if dtype == torch.float32 \
            else lstm.lstm_scan_ref
    else:
        args = (xp, w, _rand(rng, dev, dtype, G * H, scale=0.1), h0)
        fwd = gru.gru_fwd
        plain = gru.gru_scan_split if dtype == torch.float32 \
            else gru.gru_scan_ref
    assert mod.fwd_body(H, dtype) == "cluster"
    before = dict(fwd.body_launches)
    got = fwd(*args, save_residuals=True)
    again = fwd(*args, save_residuals=True)
    evals = fwd(*args)
    torch.cuda.synchronize()
    assert fwd.body_launches == {**before,
                                 "cluster": before["cluster"] + 3}
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    assert len(evals) == G // 2 + 1
    for g, e in zip(got, evals):
        assert torch.equal(g, e)
    for g, w_ in zip(got, plain(*args, save_residuals=True)):
        assert g.shape == w_.shape and g.dtype == w_.dtype
        torch.testing.assert_close(g.float(), w_.float(), **K1_TOL[dtype])


GRID_CASES = [("LSTM", 32, 128, 1056), ("LSTM", 4, 128, 4096),
              ("LSTM", 3, 5, 264), ("LSTM", 40, 7, 2048), ("LSTM", 5, 9, 2000),
              ("GRU", 32, 128, 512), ("GRU", 32, 128, 768),
              ("GRU", 4, 128, 4096), ("GRU", 3, 5, 288),
              ("LSTM", 4, 128, 8192), ("GRU", 4, 128, 8192),
              ("LSTM", 17, 5, 8192), ("GRU", 9, 5, 7008)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode,B,T,H", GRID_CASES)
def test_grid_bodies(dev, mode, dtype, B, T, H):
    """K1's and K4's grid bodies (csrc/rnn_grid.cuh) at the paths' shapes
    (--hiddenGar 1056 at B 32, the GRU at 512 and 768, both at 4096 and
    B 4), at H just past 256 with B 3 and T 5 (the last CTA holds fewer
    units, the n8 tile 3 rows), at B 40 (two launches of the batch walk,
    H 2048 streamed) and at H 2000 (a warp's chunks a step no multiple of
    its ring's stages; K4 at 4096 too), at H 8192 (--hiddenGar 8192: J
    64 units a CTA on 132 SMs, 72 on 114; 16 or 8 rows a launch, B 17 in
    two or three; the float32 backward's chunks in two pieces) and K4 at
    7008 (J 54 on 132 SMs, its float32 chunks whole): every output of
    the forward against the plain
    forward (``K1_TOL``: chip_smoke's), the backward's within 1e-4 of the
    2-norm (a nonzero dhT, and dcT), each body counted, and reruns
    bit-identical."""
    rng = np.random.RandomState(B + T + H + 2)
    G = 4 if mode == "LSTM" else 3
    mod = lstm if mode == "LSTM" else gru
    xp = _rand(rng, dev, dtype, B, T, G * H)
    w = _rand(rng, dev, dtype, G * H, H, scale=H ** -0.5)
    h0 = _rand(rng, dev, dtype, B, H, scale=0.1)
    if mode == "LSTM":
        args = (xp, w, h0, _rand(rng, dev, dtype, B, H, scale=0.1))
        fwd, ref, bwd, bref = (lstm.lstm_fwd, lstm.lstm_scan_ref,
                               lstm.lstm_bwd, lstm.lstm_bwd_ref)
    else:
        args = (xp, w, _rand(rng, dev, dtype, G * H, scale=0.1), h0)
        fwd, ref, bwd, bref = (gru.gru_fwd, gru.gru_scan_ref, gru.gru_bwd,
                               gru.gru_bwd_ref)
    assert mod.fwd_body(H, dtype) == mod.bwd_body(H, dtype) == "grid"
    before = (fwd.body_launches["grid"], bwd.body_launches["grid"])
    got = fwd(*args, save_residuals=True)
    again = fwd(*args, save_residuals=True)
    want = ref(*args, save_residuals=True)
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    for g, w_ in zip(got, want):
        assert g.shape == w_.shape and g.dtype == w_.dtype
        torch.testing.assert_close(g.float(), w_.float(), **K1_TOL[dtype])
    dys = _rand(rng, dev, dtype, B, T, H, scale=0.1)
    dhT = _rand(rng, dev, torch.float32, B, H, scale=0.1)
    if mode == "LSTM":
        bargs = (want[3], want[4], args[3], dys, w, dhT,
                 _rand(rng, dev, torch.float32, B, H, scale=0.1))
    else:
        bargs = (want[2], want[3], h0, want[0], dys, w, dhT)
    got = bwd(*bargs)
    again = bwd(*bargs)
    torch.cuda.synchronize()
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    for i, (g, w_) in enumerate(zip(got, bref(*bargs))):
        assert g.shape == w_.shape and g.dtype == w_.dtype
        err = _rel_norm(g, w_)
        assert err <= 1e-4, f"output {i}: rel_norm_err {err:.3e}"
    assert (fwd.body_launches["grid"], bwd.body_launches["grid"]) == (
        before[0] + 2, before[1] + 2)


# ---- K6 (the heads' whole attention block) and K7 (fused conv layer) --------

@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("K,B,S,h,dk", [(2, 3, 20, 4, 16), (2, 2, 116, 8, 32),
                                        (1, 1, 7, 4, 16), (2, 3, 65, 8, 32),
                                        (3, 1, 65, 4, 16), (2, 3, 7, 2, 32)])
def test_attention_block_kernels(dev, dtype, K, B, S, h, dk, rate):
    """Forward and backward against the plain versions with the same seed,
    each rerun bit for bit; S = 116, 8 x 32: the train shapes' rows.  B 1
    and 3, S 7 and 65 leave ragged GEMM tiles (M = B S rows of 128) and
    ragged attention tiles; K2's launch counts do not move (K6 reaches
    K2's body through its own C entry points)."""
    rng = np.random.RandomState(S + dk)
    D = h * dk
    args = [_rand(rng, dev, dtype, B * S, D)]
    args += [_rand(rng, dev, dtype, K, D, D, scale=D ** -0.5)
             for _ in range(4)]
    args.append(_rand(rng, dev, dtype, K, dk, S, scale=0.5))
    seed = _seed(dev)
    k2 = (head_attention.relpos_attention.launches,
          head_attention.relpos_attention_bwd.launches)
    before = attention_block.attention_block.launches
    # bf16: x = round(c + round(att)) with |att| up to 8, so where c and
    # att cancel, a one-ulp flip of round(att) (2**-5 at 4-8) stands
    # whole beside a small x
    tol = TOL[dtype] if dtype == torch.float32 else dict(atol=2 ** -4,
                                                         rtol=2e-2)
    x, saved = attention_block.attention_block_fwd(*args, B, h, rate, seed)
    torch.testing.assert_close(
        x, attention_block.attention_block_ref(*args, B, h, rate, seed), **tol)
    assert attention_block.attention_block.launches == before + 1
    x2, saved2 = attention_block.attention_block_fwd(*args, B, h, rate, seed)
    for a, b in zip((x,) + saved, (x2,) + saved2):
        assert torch.equal(a, b)
    dout = _rand(rng, dev, dtype, K, B * S, D)
    before = attention_block.attention_block_bwd.launches
    got = attention_block.attention_block_bwd(*args, dout, saved, B, h, rate,
                                              seed)
    assert attention_block.attention_block_bwd.launches == before + 1
    want = attention_block.attention_block_bwd_ref(*args, dout, B, h, rate,
                                                   seed)
    for name, g, w in zip(("dc", "dwq", "dwk", "dwv", "dwo", "dkrel"), got,
                          want):
        _close(g, w, BWD_REL[dtype], name)
    again = attention_block.attention_block_bwd(*args, dout, saved2, B, h,
                                                rate, seed)
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    assert (head_attention.relpos_attention.launches,
            head_attention.relpos_attention_bwd.launches) == k2


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,T,C,k,s,p", [(2, 64, 64, 8, 4, 2),
                                         (2, 160, 128, 4, 2, 1),
                                         (1, 33, 64, 4, 2, 1),
                                         (2, 300, 256, 8, 4, 2),
                                         (3, 300, 192, 8, 4, 2),
                                         (3, 97, 64, 4, 2, 1),
                                         (1, 256, 256, 4, 2, 1),
                                         (2, 5, 64, 8, 4, 2),
                                         (2, 9, 128, 4, 2, 3)])
def test_conv_ln_kernels(dev, dtype, B, T, C, k, s, p):
    """Forward and backward against the plain versions, and reruns
    bit-identical: T = 33 leaves a padded row no frame reads (its dx is
    0); T = 160 and 300: several 128-frame tiles and block rows; C = 256
    at layer 1's geometry; B 3 at C 192 and 64 with 75 and 48 frames, no
    multiple of the tile; layer 4's 128 frames at B 1; T = 5: the one
    frame reads padding at both ends; pad 3: the first frame's window
    lies wholly in the padding."""
    rng = np.random.RandomState(T + C)
    f32 = torch.float32
    args = (_rand(rng, dev, dtype, B, T, C),
            _rand(rng, dev, dtype, k * C, C, scale=(k * C) ** -0.5),
            _rand(rng, dev, f32, C, scale=0.1),
            _rand(rng, dev, f32, C, scale=0.1, shift=1.0),
            _rand(rng, dev, f32, C, scale=0.1))
    before = conv_ln.conv_ln_relu.launches
    out, saved = conv_ln.conv_ln_relu_fwd(*args, s, k, p)
    torch.testing.assert_close(out, conv_ln.conv_ln_relu_ref(*args, s, k, p),
                               **TOL[dtype])
    assert conv_ln.conv_ln_relu.launches == before + 1
    again, saved2 = conv_ln.conv_ln_relu_fwd(*args, s, k, p)
    assert torch.equal(out, again)
    assert all(torch.equal(a, b) for a, b in zip(saved, saved2))
    out_t = conv_ln.out_frames(T, k, s, p)
    dy = _rand(rng, dev, dtype, B, out_t, C)
    before = conv_ln.conv_ln_relu_bwd.launches
    got = conv_ln.conv_ln_relu_bwd(*args, dy, saved, s, k, p)
    assert conv_ln.conv_ln_relu_bwd.launches == before + 1
    want = conv_ln.conv_ln_relu_bwd_ref(*args, dy, s, k, p)
    for name, g, w in zip(("dx", "dw", "db", "dnw", "dnb"), got, want):
        _close(g, w, BWD_REL[dtype], name)
    again = conv_ln.conv_ln_relu_bwd(*args, dy, saved2, s, k, p)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


def test_fused_wrappers_reject_what_kernels_do_not_take(dev):
    c = torch.zeros(16, 64, device=dev)
    w = torch.zeros(1, 64, 64, device=dev)
    with pytest.raises(ValueError, match="attention_block_supported"):
        attention_block.attention_block_fwd(c, w, w, w, w,
                                            torch.zeros(1, 8, 16, device=dev),
                                            1, 8)              # dk = 8
    with pytest.raises(ValueError, match="no residuals"):
        attention_block.attention_block_bwd(
            c, w, w, w, w, torch.zeros(1, 16, 16, device=dev),
            torch.zeros(1, 16, 64, device=dev), None, 1, 4)   # no saved
    x = torch.zeros(1, 16, 64, device=dev)
    v = torch.zeros(64, device=dev)
    with pytest.raises(ValueError, match="fused_conv_supported"):
        conv_ln.conv_ln_relu_fwd(x, torch.zeros(3 * 64, 64, device=dev), v,
                                 v, v, 2, 3, 1)                # k != 2 s
    with pytest.raises(ValueError, match="no residuals"):
        conv_ln.conv_ln_relu_bwd(x, torch.zeros(4 * 64, 64, device=dev), v,
                                 v, v, torch.zeros(1, 8, 64, device=dev),
                                 None, 2, 4, 1)                # no saved


# ---- K8: the row scatter-add ---------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("J,C,R,keys", [
    (5000, 256, 301, "random"), (5000, 64, 301, "random"),
    (3000, 256, 37, "one row"), (400, 256, 1000, "half the rows"),
    (1, 64, 13, "random"), (1, 256, 5, "one row"),
    (3000, 768, 301, "random"), (2000, 1024, 37, "random"),
    (2000, 200, 37, "random"), (2000, 1056, 37, "random"),
    (500, 2056, 37, "one row")])
def test_scatter_add_kernel(dev, dtype, J, C, R, keys):
    """K8 against index_add_ into float32 zeros: random keys, all keys on
    one row, rows with no update (exactly 0), J = 1, C = 64 (8 active
    lanes in bf16), 256, 768 and 1024 (float32: 6 and 8 16-byte chunks a
    lane), 200 (no multiple of 32), 1056 and 2056 (float32 rows past 4096
    bytes, walked in 4096-byte pieces; 2056 in bf16 too), R not a
    multiple of the 8 rows a block; two
    launches on the same inputs are bit-equal.  Float32 sums in another
    order (index_add_ adds with atomics): within 1e-5 of the largest
    entry."""
    rng = np.random.RandomState(J + C + R)
    upd = _rand(rng, dev, dtype, J, C)
    if keys == "one row":
        k = np.full(J, R // 2)
    elif keys == "half the rows":
        k = 2 * rng.randint(0, R // 2, J)
    else:
        k = rng.randint(0, R, J)
    k = torch.from_numpy(k).to(dev)
    before = scatter_add.scatter_add_rows.launches
    got = scatter_add.scatter_add_rows(upd, k, R)
    assert scatter_add.scatter_add_rows.launches == before + 1
    want = scatter_add.scatter_add_rows_ref(upd, k, R)
    assert got.dtype == torch.float32 and got.shape == (R, C)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * want.abs().max().item())
    empty = torch.ones(R, dtype=torch.bool, device=dev)
    empty[k] = False
    assert (got[empty] == 0).all()
    assert torch.equal(got, scatter_add.scatter_add_rows(upd, k, R))


def test_scatter_add_wrapper_rejects_what_the_kernel_does_not_take(dev):
    k = torch.zeros(4, dtype=torch.int64, device=dev)
    with pytest.raises(ValueError, match="16 bytes"):
        scatter_add.scatter_add_rows(
            torch.zeros(4, 4, device=dev, dtype=torch.bfloat16), k, 2)
    with pytest.raises(ValueError, match="dtype"):
        scatter_add.scatter_add_rows(torch.zeros(4, 64, device=dev).half(),
                                     k, 2)
    with pytest.raises(ValueError, match="contiguous"):
        scatter_add.scatter_add_rows(torch.zeros(64, 4, device=dev).t(), k,
                                     2)
    with pytest.raises(ValueError, match="several devices"):
        scatter_add.scatter_add_rows(torch.zeros(4, 64, device=dev),
                                     k.cpu(), 2)
