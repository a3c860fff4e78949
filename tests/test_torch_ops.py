"""The port's kernel modules (cpc_audio_tpu_torch/ops) against the JAX
package's Pallas kernels, run in interpret mode on the CPU as the JAX
package's own tests run them.

Each plain version (``*_ref``) gets the same numpy inputs as the JAX
function; all comparisons are float32.  The CUDA kernels themselves run
only on a GPU: their parity with the plain versions is checked by
tests/test_torch_cuda.py and by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cpc_audio_tpu.ops import feistel as jfeistel
from cpc_audio_tpu.ops.pallas.ffn import fused_layer_tail
from cpc_audio_tpu.ops.pallas.head_attention import fused_relpos_attention
from cpc_audio_tpu.ops.pallas.rnn import lstm_scan_pallas
from cpc_audio_tpu_torch.ops import feistel, ffn, head_attention, lstm


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


# ---- K1: LSTM recurrence ----------------------------------------------------

@pytest.mark.parametrize("B,T,H", [(3, 16, 8), (2, 24, 32)])
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
    q = torch.zeros(1, 8, 8)
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        head_attention.relpos_attention(q, q, q, torch.zeros(1, 8, 8), 1, 1,
                                        rate=0.1)
    w = torch.zeros(1, 8, 8)
    v = torch.zeros(1, 8)
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        ffn.layer_tail(q, v, v, w, v, w, v, v, v, rate=0.1)


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
