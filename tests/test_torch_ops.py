"""The port's kernel modules (cpc_audio_tpu_torch/ops) against the JAX
package's Pallas kernels, run in interpret mode on the CPU as the JAX
package's own tests run them.

Each plain version (``*_ref``, and each plain backward ``*_bwd_ref``)
gets the same numpy inputs as the JAX function (``jax.vjp`` for the
backward, at dropout rate 0: the TPU's bits are not reproduced); all
comparisons are float32.  At rate 0.1 each plain backward is held against
torch autograd through its plain forward with the same seed, which checks
that the backward regenerates the forward's dropout mask.  The CUDA
kernels themselves run only on a GPU: their parity with the plain
versions is checked by tests/test_torch_cuda.py and by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cpc_audio_tpu.ops import feistel as jfeistel
from cpc_audio_tpu.ops.pallas.ffn import fused_layer_tail
from cpc_audio_tpu.ops.pallas.head_attention import fused_relpos_attention
from cpc_audio_tpu.ops.pallas.rnn import lstm_scan_pallas
from cpc_audio_tpu_torch.ops import dropout, feistel, ffn, head_attention, lstm


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


# ---- K1: LSTM recurrence ----------------------------------------------------

@pytest.mark.parametrize("B,T,H", [(3, 16, 8), (2, 24, 32), (2, 4, 768)])
def test_lstm_ref_matches_pallas_interpret(B, T, H):
    rng = np.random.RandomState(B * 100 + H)
    xp = rng.randn(B, T, 4 * H).astype(np.float32)
    w_hh = (rng.randn(4 * H, H) * 0.3).astype(np.float32)   # torch (4H, H)
    h0 = (rng.randn(B, H) * 0.1).astype(np.float32)
    c0 = (rng.randn(B, H) * 0.1).astype(np.float32)
    ys_j, hT_j, cT_j = lstm_scan_pallas(jnp.asarray(xp), jnp.asarray(w_hh.T),
                                        jnp.asarray(h0), jnp.asarray(c0),
                                        True)
    ys, hT, cT = lstm.lstm_scan_ref(_t(xp), _t(w_hh), _t(h0), _t(c0))
    # f32 both sides; only the summation order of h . W differs
    for got, want in ((ys, ys_j), (hT, hT_j), (cT, cT_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_lstm_wrapper_runs_ref_on_cpu():
    rng = np.random.RandomState(0)
    B, T, H = 2, 5, 4
    args = (_t(rng.randn(B, T, 4 * H)), _t(rng.randn(4 * H, H)),
            _t(rng.randn(B, H)), _t(rng.randn(B, H)))
    before = lstm.lstm_fwd.launches
    for got, want in zip(lstm.lstm_fwd(*args), lstm.lstm_scan_ref(*args)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert lstm.lstm_fwd.launches == before     # no kernel on the CPU


# ---- K2: rel-pos attention --------------------------------------------------

def _attn_inputs(rng, K, B, S, h, dk):
    D = h * dk
    q, k, v = (rng.randn(K, B * S, D).astype(np.float32) for _ in range(3))
    krel = (rng.randn(K, dk, S) * 0.5).astype(np.float32)
    return q, k, v, krel


def _jax_relpos(q, k, v, krel, B, S, h):
    """The Pallas kernel (interpret mode) needs S % 128 == 0: pad the
    sequence and left-pad Krelpos on the JAX side only, exactly as
    stacked_heads.py:167-170 does, then slice the padded rows away."""
    K, _, D = q.shape
    Sp = -(-S // 128) * 128

    def pad(t):
        t = t.reshape(K, B, S, D)
        return jnp.pad(t, ((0, 0), (0, 0), (0, Sp - S), (0, 0))) \
            .reshape(K, B * Sp, D)

    kr = jnp.pad(jnp.asarray(krel), ((0, 0), (0, 0), (Sp - S, 0)))
    y = fused_relpos_attention(pad(jnp.asarray(q)), pad(jnp.asarray(k)),
                               pad(jnp.asarray(v)), kr,
                               jnp.zeros((1,), jnp.float32), B, h, 0.0, True)
    return np.asarray(y).reshape(K, B, Sp, D)[:, :, :S].reshape(K, B * S, D)


@pytest.mark.parametrize("S", [116, 128])
def test_relpos_attention_ref_matches_pallas_interpret(S):
    """S = 116 (not a power of two) is the eval path's length: the port
    indexes krel[:, j - i + S - 1] without the JAX padding."""
    K, B, h, dk = 2, 2, 2, 8
    q, k, v, krel = _attn_inputs(np.random.RandomState(S), K, B, S, h, dk)
    want = _jax_relpos(q, k, v, krel, B, S, h)
    got = head_attention.relpos_attention_ref(_t(q), _t(k), _t(v), _t(krel),
                                              B, h)
    # f32 both sides; softmax sums in another order
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_relpos_skew_index_is_pallas_skew():
    """The bias the plain version uses is q_i . krel[:, (j - i - 1) mod S]
    (head_attention.py:53-63) on the causal region: check one row by hand."""
    K, B, S, h, dk = 1, 1, 7, 1, 4
    q, k, v, krel = _attn_inputs(np.random.RandomState(3), K, B, S, h, dk)
    i = 5
    s = np.array([q[0, i] @ (k[0, j] + krel[0, :, (j - i - 1) % S])
                  for j in range(i + 1)]) / np.sqrt(dk)
    p = np.exp(s - s.max())
    p /= p.sum()
    want = p @ v[0, :i + 1]
    got = head_attention.relpos_attention_ref(_t(q), _t(k), _t(v), _t(krel),
                                              B, h)
    np.testing.assert_allclose(got[0, i].numpy(), want, atol=1e-5)


def test_attention_and_tail_refuse_dropout():
    """Dropout runs only with a seed and a rate in [0, 1): the wrappers
    refuse anything else, and with a seed they drop."""
    q = torch.zeros(1, 8, 8)
    with pytest.raises(ValueError, match="needs a seed"):
        head_attention.relpos_attention(q, q, q, torch.zeros(1, 8, 8), 1, 1,
                                        rate=0.1)
    with pytest.raises(ValueError, match=r"not in \[0, 1\)"):
        head_attention.relpos_attention(q, q, q, torch.zeros(1, 8, 8), 1, 1,
                                        rate=1.0, seed=torch.zeros(1).long())
    w = torch.zeros(1, 8, 8)
    v = torch.zeros(1, 8)
    with pytest.raises(ValueError, match="needs a seed"):
        ffn.layer_tail(q, v, v, w, v, w, v, v, v, rate=0.1)
    with pytest.raises(ValueError, match="int64 tensor"):
        ffn.layer_tail(q, v, v, w, v, w, v, v, v, rate=0.1,
                       seed=torch.zeros(1))
    rng = np.random.RandomState(4)
    args = [_t(a) for a in _tail_inputs(rng, 1, 8, 32, 64)]
    seed = torch.tensor([7])
    assert not torch.equal(ffn.layer_tail(*args, rate=0.5, seed=seed),
                           ffn.layer_tail(*args))


# ---- K3: layer tail -----------------------------------------------------------

def _tail_inputs(rng, K, M, D, F):
    return (rng.randn(K, M, D) * 0.5, 1.0 + 0.1 * rng.randn(K, D),
            0.1 * rng.randn(K, D), rng.randn(K, D, F) / np.sqrt(D),
            0.1 * rng.randn(K, F), rng.randn(K, F, D) / np.sqrt(F),
            0.1 * rng.randn(K, D), 1.0 + 0.1 * rng.randn(K, D),
            0.1 * rng.randn(K, D))


@pytest.mark.parametrize("K,M,D,F", [(2, 64, 128, 256), (3, 24, 128, 384)])
def test_layer_tail_ref_matches_pallas_interpret(K, M, D, F):
    args = [a.astype(np.float32)
            for a in _tail_inputs(np.random.RandomState(M), K, M, D, F)]
    want = fused_layer_tail(*map(jnp.asarray, args),
                            jnp.zeros((1,), jnp.float32), 0.0, 1e-5, True)
    got = ffn.layer_tail_ref(*map(_t, args))
    # f32 both sides; F-long sums in another order
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-5)


def test_layer_tail_wrapper_runs_ref_on_cpu():
    args = [_t(a) for a in _tail_inputs(np.random.RandomState(1), 2, 8, 32,
                                        64)]
    before = ffn.layer_tail.launches
    torch.testing.assert_close(ffn.layer_tail(*args),
                               ffn.layer_tail_ref(*args), rtol=0, atol=0)
    assert ffn.layer_tail.launches == before


# ---- Feistel permutation ------------------------------------------------------

@pytest.mark.parametrize("nbits", [5, 8, 12, 13])
def test_feistel_bit_equal_to_jax(nbits):
    rng = np.random.RandomState(nbits)
    keys = rng.randint(0, 2 ** 32, size=jfeistel.ROUNDS, dtype=np.uint64)
    x = np.arange(2 ** nbits, dtype=np.uint32)
    keys_j = jnp.asarray(keys.astype(np.uint32))
    perm_j = np.asarray(jfeistel.feistel_permute(jnp.asarray(x), keys_j,
                                                 nbits))
    inv_j = np.asarray(jfeistel.feistel_inverse(jnp.asarray(x), keys_j,
                                                nbits))
    keys_t = torch.from_numpy(keys.astype(np.int64))
    xt = torch.arange(2 ** nbits)
    perm = feistel.feistel_permute(xt, keys_t, nbits)
    inv = feistel.feistel_inverse(xt, keys_t, nbits)
    np.testing.assert_array_equal(perm.numpy(), perm_j.astype(np.int64))
    np.testing.assert_array_equal(inv.numpy(), inv_j.astype(np.int64))
    np.testing.assert_array_equal(perm[inv].numpy(), x.astype(np.int64))


# ---- backward: plain versions against jax.vjp of the Pallas kernels ----------

def _grads_close(got, want, rel, names):
    """max |got - want| <= rel * max |want| per gradient."""
    for name, g, w in zip(names, got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, (name, g.shape, w.shape)
        err = np.abs(g - w).max()
        assert err <= rel * np.abs(w).max() + 1e-7, (name, err)


def test_lstm_bwd_ref_matches_pallas_vjp():
    """The port's LSTM backward (plain reverse scan + dW_hh matmul, through
    the autograd Function) against jax.vjp of lstm_scan_pallas."""
    rng = np.random.RandomState(11)
    B, T, H = 2, 16, 8
    xp = rng.randn(B, T, 4 * H).astype(np.float32)
    w_hh = (rng.randn(4 * H, H) * 0.3).astype(np.float32)
    h0, c0 = ((rng.randn(B, H) * 0.1).astype(np.float32) for _ in range(2))
    cot = (rng.randn(B, T, H).astype(np.float32),
           rng.randn(B, H).astype(np.float32),
           rng.randn(B, H).astype(np.float32))
    _, vjp = jax.vjp(lambda a, w, h, c: lstm_scan_pallas(a, w, h, c, True),
                     jnp.asarray(xp), jnp.asarray(w_hh.T), jnp.asarray(h0),
                     jnp.asarray(c0))
    dxp_j, dwt_j, dh0_j, dc0_j = vjp(tuple(map(jnp.asarray, cot)))
    ins = [_t(a).requires_grad_() for a in (xp, w_hh, h0, c0)]
    outs = lstm.lstm(*ins)
    got = torch.autograd.grad(outs, ins, [_t(c) for c in cot])
    # f32 both sides; sums in another order
    _grads_close(got, (dxp_j, np.asarray(dwt_j).T, dh0_j, dc0_j), 1e-5,
                 ("dx_proj", "dw_hh", "dh0", "dc0"))


def _jax_relpos_fn(B, S, h):
    """fused_relpos_attention in interpret mode on unpadded inputs, with
    the S -> 128 padding of _jax_relpos inside (so its vjp is unpadded)."""
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


def test_relpos_attention_bwd_ref_matches_pallas_vjp():
    K, B, S, h, dk = 2, 2, 116, 2, 8
    rng = np.random.RandomState(12)
    q, k, v, krel = _attn_inputs(rng, K, B, S, h, dk)
    dout = rng.randn(K, B * S, h * dk).astype(np.float32)
    _, vjp = jax.vjp(_jax_relpos_fn(B, S, h),
                     *map(jnp.asarray, (q, k, v, krel)))
    want = vjp(jnp.asarray(dout))
    got = head_attention.relpos_attention_bwd_ref(
        *map(_t, (q, k, v, krel, dout)), B, h)
    # f32 both sides; softmax and the dkrel sum over (b, h, i) in another
    # order
    _grads_close(got, want, 1e-5, ("dq", "dk", "dv", "dkrel"))


def test_layer_tail_bwd_ref_matches_pallas_vjp():
    K, M, D, F = 2, 64, 128, 256
    args = [a.astype(np.float32)
            for a in _tail_inputs(np.random.RandomState(13), K, M, D, F)]
    dout = np.random.RandomState(14).randn(K, M, D).astype(np.float32)
    seed = jnp.zeros((1,), jnp.float32)
    _, vjp = jax.vjp(lambda *a: fused_layer_tail(*a, seed, 0.0, 1e-5, True),
                     *map(jnp.asarray, args))
    want = vjp(jnp.asarray(dout))
    got = ffn.layer_tail_bwd_ref(*map(_t, args), _t(dout))
    # f32 both sides; F- and row-long sums in another order
    _grads_close(got, want, 1e-5, ("dx", "dln1w", "dln1b", "dw1", "db1",
                                   "dw2", "db2", "dln2w", "dln2b"))


# ---- backward at rate 0.1: plain backward vs autograd of the plain forward ---

def _autograd_vs_bwd(fwd, bwd, inputs, dout, names):
    ins = [t.clone().requires_grad_() for t in inputs]
    want = torch.autograd.grad(fwd(*ins), ins, dout)
    got = bwd(*inputs, dout)
    # f32 both sides; the same operations in another order
    _grads_close([g.detach() for g in got], [w.detach() for w in want],
                 1e-5, names)


def test_relpos_attention_bwd_regenerates_dropout_mask():
    K, B, S, h, dk = 2, 3, 20, 2, 8
    rng = np.random.RandomState(15)
    ins = [_t(a) for a in _attn_inputs(rng, K, B, S, h, dk)]
    dout = _t(rng.randn(K, B * S, h * dk))
    seed = torch.tensor([99])
    _autograd_vs_bwd(
        lambda *a: head_attention.relpos_attention_ref(*a, B, h, 0.1, seed),
        lambda *a: head_attention.relpos_attention_bwd_ref(*a, B, h, 0.1,
                                                           seed),
        ins, dout, ("dq", "dk", "dv", "dkrel"))


def test_layer_tail_bwd_regenerates_dropout_mask():
    K, M, D, F = 2, 24, 32, 64
    ins = [_t(a) for a in _tail_inputs(np.random.RandomState(16), K, M, D,
                                       F)]
    dout = _t(np.random.RandomState(17).randn(K, M, D))
    seed = torch.tensor([5])
    _autograd_vs_bwd(
        lambda *a: ffn.layer_tail_ref(*a, 1e-5, 0.1, seed),
        lambda *a: ffn.layer_tail_bwd_ref(*a, 1e-5, 0.1, seed),
        ins, dout, ("dx", "dln1w", "dln1b", "dw1", "db1", "dw2", "db2",
                    "dln2w", "dln2b"))


def test_lstm_bwd_ref_matches_autograd():
    """The LSTM has no dropout: its plain backward against autograd
    through the plain time loop."""
    rng = np.random.RandomState(18)
    B, T, H = 3, 7, 8
    ins = [_t(rng.randn(B, T, 4 * H)), _t(rng.randn(4 * H, H) * 0.3),
           _t(rng.randn(B, H) * 0.1), _t(rng.randn(B, H) * 0.1)]
    cot = [_t(rng.randn(B, T, H)), _t(rng.randn(B, H)), _t(rng.randn(B, H))]
    a = [t.clone().requires_grad_() for t in ins]
    want = torch.autograd.grad(lstm.lstm_scan_ref(*a), a, cot)
    b = [t.clone().requires_grad_() for t in ins]
    got = torch.autograd.grad(lstm.lstm(*b), b, cot)
    _grads_close(got, want, 1e-5, ("dx_proj", "dw_hh", "dh0", "dc0"))


# ---- dropout bits -------------------------------------------------------------

def _bits_numpy(seed, site, w1, w2):
    """The generator in numpy uint32 arithmetic, as csrc/dropout.cuh
    computes it: an independent check of the int64-masked torch version."""
    def mix(x, k):
        h = (np.uint32(x) ^ np.uint32(k)) * np.uint32(0x9E3779B1)
        h ^= h >> np.uint32(15)
        h = h * np.uint32(0x85EBCA6B)
        return h ^ (h >> np.uint32(13))

    with np.errstate(over="ignore"):
        h = mix(w2, mix(w1, mix(seed, site)))
        h ^= h >> np.uint32(16)
        h = h * np.uint32(0x85EBCA6B)
        h ^= h >> np.uint32(13)
        h = h * np.uint32(0xC2B2AE35)
        return h ^ (h >> np.uint32(16))


def test_dropout_bits_match_uint32_arithmetic():
    w1 = np.arange(0, 4000, 37, dtype=np.uint32)
    w2 = np.arange(3, 900, 13, dtype=np.uint32)
    for seed, site in ((0, 1), (0xDEADBEEF, 2), (12345, 3)):
        want = _bits_numpy(np.uint32(seed), site, w1[:, None], w2[None, :])
        got = dropout.bits(torch.tensor([seed]), site,
                           torch.from_numpy(w1.astype(np.int64))[:, None],
                           torch.from_numpy(w2.astype(np.int64))[None, :])
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_dropout_keep_share_within_binomial_bounds():
    seed = torch.tensor([2024])
    for rate in (0.1, 0.5):
        mask = dropout.ffn_mask(seed, rate, 4, 500, 512, "cpu")
        n = mask.numel()
        keep = (mask > 0).float().mean().item()
        sigma = (rate * (1 - rate) / n) ** 0.5
        assert abs(keep - (1 - rate)) < 5 * sigma, (rate, keep)
        assert torch.allclose(mask[mask > 0], torch.tensor(1 / (1 - rate)))


def test_dropout_masks_are_keyed_on_absolute_indices():
    """A slice's mask equals the full mask sliced (the backward's tiling
    does not matter), and other heads, rows, sites and seeds differ."""
    seed = torch.tensor([77])
    K, B, h, S = 2, 3, 2, 20
    full = dropout.attention_mask(seed, 0.5, K, B, h, S, "cpu")
    k, b, hd = 1, 2, 1
    i = torch.arange(5, 11)[:, None]
    j = torch.arange(3, 9)[None, :]
    part = dropout.bits(seed, dropout.SITE_ATTENTION,
                        torch.tensor((k * B + b) * h + hd), i * S + j)
    np.testing.assert_array_equal(
        (part >= dropout.threshold(0.5)).numpy(),
        (full[k, b, hd, 5:11, 3:9] > 0).numpy())
    assert not torch.equal(full[0, 0, 0], full[0, 0, 1])      # heads
    assert not torch.equal(full[0, 0, 0], full[0, 1, 0])      # batch rows
    assert not torch.equal(full[0, 0, 0], full[1, 0, 0])      # k
    M, F = 40, 64
    ffn_full = dropout.ffn_mask(seed, 0.5, K, M, F, "cpu")
    rows = dropout.bits(seed, dropout.SITE_FFN,
                        torch.arange(M + 7, M + 19)[:, None],
                        torch.arange(F)[None, :])
    np.testing.assert_array_equal(
        (rows >= dropout.threshold(0.5)).numpy(),
        (ffn_full[1, 7:19] > 0).numpy())
    assert not torch.equal(ffn_full[0, 0], ffn_full[0, 1])    # rows
    w1, w2 = torch.arange(64)[:, None], torch.arange(64)[None, :]
    sites = [dropout.bits(seed, s, w1, w2) for s in
             (dropout.SITE_ATTENTION, dropout.SITE_FFN,
              dropout.SITE_PREDICTION)]
    assert not torch.equal(sites[0], sites[1])
    assert not torch.equal(sites[1], sites[2])
    assert not torch.equal(sites[0], dropout.bits(torch.tensor([78]),
                                                  dropout.SITE_ATTENTION,
                                                  w1, w2))
