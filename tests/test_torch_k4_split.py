"""K4's float32 cluster- and grid-body arithmetic, written plainly on the
CPU.

On the card K4's float32 forward at H 128 and 256 (the cluster body,
csrc/rnn_cluster_fwd.cuh) and its forward and backward past H 256
(csrc/rnn_grid.cuh, through csrc/gru_fwd.cu and csrc/gru_bwd.cu) run each
step's product on bf16 tensor cores with split operands: h (forward) or
dgh = (dr, dz, dghn) (backward) and W_hh each as bf16 hi + lo, and 3 split
products h_hi W_hi + h_lo W_hi + h_hi W_lo summed in float32.
``gru.gru_scan_split`` and ``gru.gru_bwd_split`` are that arithmetic in
plain PyTorch; here they are held against float64 recurrences and against
the JAX package's float32 ``gru_scan_pallas`` and its custom VJP
(interpret mode), within chip_smoke.py's float32 K4 tolerances: forward
outputs elementwise within 2e-4, backward outputs within 1e-4 of their
2-norm.  The kernels themselves run only on a GPU
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cpc_audio_tpu.ops.pallas.rnn import gru_scan_pallas
from cpc_audio_tpu_torch.ops import gru

# chip_smoke.py's TOLERANCE for K4 in float32
FWD_ATOL = 2e-4
BWD_REL = 1e-4


def _inputs(B, T, H, seed):
    """chip_smoke's K4 inputs: x_proj ~ N(0, 1), W_hh ~ N(0, 1 / H), b_hh
    and h0 ~ N(0, 0.01), the cotangent of ys ~ N(0, 0.01)."""
    rng = np.random.RandomState(seed)
    xp = rng.randn(B, T, 3 * H).astype(np.float32)
    w = (rng.randn(3 * H, H) * H ** -0.5).astype(np.float32)
    b = (rng.randn(3 * H) * 0.1).astype(np.float32)
    h0 = (rng.randn(B, H) * 0.1).astype(np.float32)
    dys = (rng.randn(B, T, H) * 0.1).astype(np.float32)
    return xp, w, b, h0, dys


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a)).to(dtype)


def _rel(got, want):
    return ((got.double() - want.double()).norm()
            / want.double().norm()).item()


# the learning gate's GRU (eval/learning_gate.py: B 8, T 32, H 64)
GATE = (8, 32, 64)


@pytest.mark.parametrize("B,T,H", [(3, 16, 32), (2, 24, 64), GATE])
def test_split_forward_matches_float64_and_pallas(B, T, H):
    """ys, hT (and the saved gates and ghn) of the split forward against
    the float64 plain forward and JAX's float32 Pallas forward,
    elementwise within the card's float32 tolerance."""
    xp, w, b, h0, _ = _inputs(B, T, H, B + T + H)
    got = gru.gru_scan_split(_t(xp), _t(w), _t(b), _t(h0),
                             save_residuals=True)
    exact = gru.gru_scan_ref(*(_t(a, torch.float64) for a in (xp, w, b, h0)),
                             save_residuals=True)
    for g, e in zip(got, exact):
        assert g.dtype == torch.float32
        assert (g.double() - e).abs().max().item() <= FWD_ATOL
    jax_out = gru_scan_pallas(jnp.asarray(xp), jnp.asarray(w.T),
                              jnp.asarray(b), jnp.asarray(h0), True)
    for g, j in zip(got[:2], jax_out):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=FWD_ATOL,
                                   rtol=0)


@pytest.mark.parametrize("B,T,H", [(3, 16, 32), (2, 24, 64), GATE])
def test_split_backward_matches_float64_and_pallas_vjp(B, T, H):
    """dx_proj, dW_hh, db_hh and dh0 from the split backward (dW_hh and
    db_hh from dx_proj and dghn, as ops/gru.py forms them) against the
    float64 plain backward and ``jax.vjp`` of JAX's float32 Pallas GRU for
    a cotangent on ys, each within 1e-4 of its 2-norm."""
    xp, w, b, h0, dys = _inputs(B, T, H, 2 * (B + T + H))
    ys, _, gates, ghn = gru.gru_scan_split(_t(xp), _t(w), _t(b), _t(h0),
                                           save_residuals=True)
    zeros = torch.zeros(B, H)
    dx, dghn, dh0 = gru.gru_bwd_split(gates, ghn, _t(h0), ys, _t(dys), _t(w),
                                      zeros)
    h_prev = torch.cat([_t(h0)[:, None], ys[:, :-1]], dim=1).reshape(B * T, H)
    drz = dx.reshape(B * T, 3 * H)[:, :2 * H]
    dg = dghn.reshape(B * T, H)
    dw = torch.cat([drz.t() @ h_prev, dg.t() @ h_prev])
    db = torch.cat([drz.sum(dim=0), dg.sum(dim=0)])
    d64 = lambda a: a.double()                      # noqa: E731
    ex, eghn, eh0 = gru.gru_bwd_ref(
        d64(gates), d64(ghn), _t(h0, torch.float64), d64(ys),
        _t(dys, torch.float64), _t(w, torch.float64), d64(zeros))
    for g, e in ((dx, ex), (dghn, eghn), (dh0, eh0)):
        assert _rel(g, e) <= BWD_REL

    def f(xp_, w_t, b_, h0_):
        return gru_scan_pallas(xp_, w_t, b_, h0_, True)[0]
    _, vjp = jax.vjp(f, jnp.asarray(xp), jnp.asarray(w.T), jnp.asarray(b),
                     jnp.asarray(h0))
    jx, jw_t, jb, jh0 = (np.asarray(a) for a in vjp(jnp.asarray(dys)))
    for g, j in ((dx, jx), (dw, jw_t.T), (db, jb), (dh0, jh0)):
        assert _rel(g, torch.from_numpy(j)) <= BWD_REL


@pytest.mark.parametrize("H", [128, 256, 512])
def test_three_split_products_hold_the_tolerance_at_h512(H):
    """Why 3 split products, as K1's: at H 128 and 256 (the cluster
    forward's widths; 256 is the default --hiddenGar) and at H 512 (the
    GRU 512 path's width), over 64 steps, the split forward stays within
    a tenth of the forward's tolerance of the float64 recurrence and,
    over its first 16 steps, within the tolerance of JAX's float32 Pallas
    forward (interpret mode), and the split backward within a tenth of
    the backward's (the dropped terms, h_lo W_lo and what two planes
    leave of each operand, are about 2^-16 of |h||W_hh| a term)."""
    B, T = 2, 64
    xp, w, b, h0, dys = _inputs(B, T, H, 5)
    got = gru.gru_scan_split(_t(xp), _t(w), _t(b), _t(h0),
                             save_residuals=True)
    f64 = [_t(a, torch.float64) for a in (xp, w, b, h0, dys)]
    exact = gru.gru_scan_ref(*f64[:4], save_residuals=True)
    err = max((g.double() - e).abs().max().item()
              for g, e in zip(got, exact))
    assert err <= 0.1 * FWD_ATOL, err
    # JAX over the first 16 steps (interpret mode costs ~0.1 s a step)
    head = gru.gru_scan_split(_t(xp[:, :16]), _t(w), _t(b), _t(h0))
    jax_out = gru_scan_pallas(jnp.asarray(xp[:, :16]), jnp.asarray(w.T),
                              jnp.asarray(b), jnp.asarray(h0), True)
    for g, j in zip(head, jax_out):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=FWD_ATOL,
                                   rtol=0)
    zeros = torch.zeros(B, H, dtype=torch.float64)
    split = gru.gru_bwd_split(exact[2].float(), exact[3].float(), _t(h0),
                              exact[0].float(), _t(dys), _t(w),
                              zeros.float())
    want = gru.gru_bwd_ref(exact[2], exact[3], f64[3], exact[0], f64[4],
                           f64[1], zeros)
    assert max(_rel(g, e) for g, e in zip(split, want)) <= 0.1 * BWD_REL


@pytest.mark.parametrize("H", [32, 64, 96, 160])
def test_resident_plain_float32_matches_pallas(H):
    """The resident forward's arithmetic is plain float32 (W_hh in
    registers, products on the FP32 cores: no split planes): the float32
    plain forward at the learning gate's B 8, T 32 (and H 64) against
    JAX's float32 Pallas forward within the card's float32 tolerance, and
    the backward from its residuals (gru_bwd_ref, as the rows and resident
    forwards feed it) against ``jax.vjp`` within 1e-4 of each 2-norm."""
    B, T = GATE[:2]
    xp, w, b, h0, dys = _inputs(B, T, H, 3 * H)
    ys, hT, gates, ghn = gru.gru_scan_ref(_t(xp), _t(w), _t(b), _t(h0),
                                          save_residuals=True)

    def f(xp_, w_t, b_, h0_):
        return gru_scan_pallas(xp_, w_t, b_, h0_, True)
    (jys, jhT), vjp = jax.vjp(f, jnp.asarray(xp), jnp.asarray(w.T),
                              jnp.asarray(b), jnp.asarray(h0))
    for g, j in ((ys, jys), (hT, jhT)):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=FWD_ATOL,
                                   rtol=0)
    dx, dghn, dh0 = gru.gru_bwd_ref(gates, ghn, _t(h0), ys, _t(dys), _t(w),
                                    torch.zeros(B, H))
    h_prev = torch.cat([_t(h0)[:, None], ys[:, :-1]], dim=1).reshape(B * T, H)
    drz = dx.reshape(B * T, 3 * H)[:, :2 * H]
    dg = dghn.reshape(B * T, H)
    dw = torch.cat([drz.t() @ h_prev, dg.t() @ h_prev])
    jx, jw_t, _, jh0 = (np.asarray(a) for a in vjp(
        (jnp.asarray(dys), jnp.zeros((B, H), jnp.float32))))
    for g, j in ((dx, jx), (dw, jw_t.T), (dh0, jh0)):
        assert _rel(g, torch.from_numpy(j)) <= BWD_REL


def test_forward_bodies_by_width():
    """K4's forward body from the shape alone (``cpc_gru_fwd_body``): the
    resident body where W_hh fits one SM's registers (float32 H 32, 64,
    96; bf16 also 160), the cluster body at 128 and 256, the rows body at
    the other widths to 256 (bf16 192 and 224, float32 160-224), the grid
    body past 256."""
    f32, bf = torch.float32, torch.bfloat16
    for H in (32, 64, 96):
        assert gru.fwd_body(H, f32) == gru.fwd_body(H, bf) == "resident"
    assert gru.fwd_body(160, bf) == "resident"
    for H in (160, 192, 224):
        assert gru.fwd_body(H, f32) == "rows"
    for H in (192, 224):
        assert gru.fwd_body(H, bf) == "rows"
    for H in (128, 256):
        assert gru.fwd_body(H, f32) == gru.fwd_body(H, bf) == "cluster"
    assert gru.fwd_body(288, f32) == gru.fwd_body(288, bf) == "grid"
    assert set(gru.gru_fwd.body_launches) == {"cluster", "grid", "resident",
                                              "rows"}
    assert gru.BODY_CODES == {"rows": 0, "cluster": 1, "grid": 2,
                              "resident": 3}
