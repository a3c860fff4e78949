"""K1's float32 cluster-body arithmetic, written plainly on the CPU.

On the card K1's float32 forward at H 128, 256, 512 and 768 and its
backward at H 512 and 768 (csrc/rnn_cluster_fwd.cuh, csrc/lstm_bwd.cu)
run each step's product on bf16
tensor cores with split operands: h (forward) or dgates (backward) and
W_hh each as bf16 hi + lo, and 3 split products h_hi W_hi + h_lo W_hi +
h_hi W_lo summed in float32.  ``lstm.lstm_scan_split`` and
``lstm.lstm_bwd_split`` are that arithmetic in plain PyTorch; here they
are held against float64 recurrences and against the JAX package's
float32 ``lstm_scan_pallas`` and its custom VJP (interpret mode), within
chip_smoke.py's float32 K1 tolerances: forward outputs elementwise within
2e-4, backward outputs within 1e-4 of their 2-norm.  The kernels
themselves run only on a GPU (tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cpc_audio_tpu.ops.pallas.rnn import lstm_scan_pallas
from cpc_audio_tpu_torch.ops import lstm

# chip_smoke.py's TOLERANCE for K1 in float32
FWD_ATOL = 2e-4
BWD_REL = 1e-4


def _inputs(B, T, H, seed):
    """chip_smoke's K1 inputs: x_proj ~ N(0, 1), W_hh ~ N(0, 1 / H), h0,
    c0 and the cotangent of ys ~ N(0, 0.01)."""
    rng = np.random.RandomState(seed)
    xp = rng.randn(B, T, 4 * H).astype(np.float32)
    w = (rng.randn(4 * H, H) * H ** -0.5).astype(np.float32)
    h0, c0 = ((rng.randn(B, H) * 0.1).astype(np.float32) for _ in range(2))
    dys = (rng.randn(B, T, H) * 0.1).astype(np.float32)
    return xp, w, h0, c0, dys


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a)).to(dtype)


def _rel(got, want):
    return ((got.double() - want.double()).norm()
            / want.double().norm()).item()


@pytest.mark.parametrize("B,T,H", [(3, 16, 32), (2, 24, 64)])
def test_split_forward_matches_float64_and_pallas(B, T, H):
    """ys, hT, cT (and the saved gates and cell states) of the split
    forward against the float64 plain forward and JAX's float32 Pallas
    forward, elementwise within the card's float32 tolerance."""
    xp, w, h0, c0, _ = _inputs(B, T, H, B + T + H)
    got = lstm.lstm_scan_split(_t(xp), _t(w), _t(h0), _t(c0),
                               save_residuals=True)
    exact = lstm.lstm_scan_ref(*(_t(a, torch.float64)
                                 for a in (xp, w, h0, c0)),
                               save_residuals=True)
    for g, e in zip(got, exact):
        assert (g.double() - e).abs().max().item() <= FWD_ATOL
    jax_out = lstm_scan_pallas(jnp.asarray(xp), jnp.asarray(w.T),
                               jnp.asarray(h0), jnp.asarray(c0), True)
    for g, j in zip(got[:3], jax_out):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=FWD_ATOL,
                                   rtol=0)


@pytest.mark.parametrize("B,T,H", [(3, 16, 32), (2, 24, 64)])
def test_split_backward_matches_float64_and_pallas_vjp(B, T, H):
    """dx_proj (= dgates), dW_hh, dh0 and dc0 from the split backward
    (dW_hh = dgates^T h_prev, as ops/lstm.py forms it) against the
    float64 plain backward and ``jax.vjp`` of JAX's float32 Pallas LSTM
    for a cotangent on ys, each within 1e-4 of its 2-norm."""
    xp, w, h0, c0, dys = _inputs(B, T, H, 2 * (B + T + H))
    ys, _, _, gates, cs = lstm.lstm_scan_split(_t(xp), _t(w), _t(h0),
                                               _t(c0), save_residuals=True)
    zeros = torch.zeros(B, H)
    dg, dh0, dc0 = lstm.lstm_bwd_split(gates, cs, _t(c0), _t(dys), _t(w),
                                       zeros, zeros)
    h_prev = torch.cat([_t(h0)[:, None], ys[:, :-1]], dim=1)
    dw = dg.reshape(B * T, -1).t() @ h_prev.reshape(B * T, -1)
    d64 = lambda a: a.double()                      # noqa: E731
    eg, eh0, ec0 = lstm.lstm_bwd_ref(
        d64(gates), d64(cs), _t(c0, torch.float64), _t(dys, torch.float64),
        _t(w, torch.float64), d64(zeros), d64(zeros))
    for g, e in ((dg, eg), (dh0, eh0), (dc0, ec0)):
        assert _rel(g, e) <= BWD_REL

    def f(xp_, w_t, h0_, c0_):
        return lstm_scan_pallas(xp_, w_t, h0_, c0_, True)[0]
    _, vjp = jax.vjp(f, jnp.asarray(xp), jnp.asarray(w.T), jnp.asarray(h0),
                     jnp.asarray(c0))
    jx, jw_t, jh0, jc0 = (np.asarray(a) for a in vjp(jnp.asarray(dys)))
    for g, j in ((dg, jx), (dw, jw_t.T), (dh0, jh0), (dc0, jc0)):
        assert _rel(g, torch.from_numpy(j)) <= BWD_REL


@pytest.mark.parametrize("H", [128, 256, 512])
def test_three_split_products_hold_the_tolerance_at_h512(H):
    """Why 3 split products, not 6: at H 128 and 256 (256 is the default
    --hiddenGar; the cluster forward takes both) and at H 512, over 64
    steps, the split forward stays within a tenth of the forward's
    tolerance of the float64 recurrence and, over its first 16 steps,
    within the tolerance of JAX's float32 Pallas forward (interpret mode),
    and the split backward within a tenth of the backward's (the dropped
    terms, h_lo W_lo and what two planes leave of each operand, are about
    2^-16 of |h||W_hh| a term; at chip_smoke's shapes, up to T 256, they
    measure 2-5e-6 both ways)."""
    B, T = 2, 64
    xp, w, h0, c0, dys = _inputs(B, T, H, 5)
    got = lstm.lstm_scan_split(_t(xp), _t(w), _t(h0), _t(c0),
                               save_residuals=True)
    f64 = [_t(a, torch.float64) for a in (xp, w, h0, c0, dys)]
    exact = lstm.lstm_scan_ref(*f64[:4], save_residuals=True)
    err = max((g.double() - e).abs().max().item()
              for g, e in zip(got, exact))
    assert err <= 0.1 * FWD_ATOL, err
    # JAX over the first 16 steps (interpret mode costs ~0.1 s a step)
    head = lstm.lstm_scan_split(_t(xp[:, :16]), _t(w), _t(h0), _t(c0))
    jax_out = lstm_scan_pallas(jnp.asarray(xp[:, :16]), jnp.asarray(w.T),
                               jnp.asarray(h0), jnp.asarray(c0), True)
    for g, j in zip(head, jax_out):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=FWD_ATOL,
                                   rtol=0)
    zeros = torch.zeros(B, H, dtype=torch.float64)
    split = lstm.lstm_bwd_split(exact[3].float(), exact[4].float(),
                                _t(c0), _t(dys), _t(w), zeros.float(),
                                zeros.float())
    want = lstm.lstm_bwd_ref(exact[3], exact[4], f64[3], f64[4], f64[1],
                             zeros, zeros)
    assert max(_rel(g, e) for g, e in zip(split, want)) <= 0.1 * BWD_REL
