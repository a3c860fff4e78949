"""The port's K4 (GRU) and K5 (causal attention with a dense bias) modules
against the JAX package's Pallas kernels, run in interpret mode on the CPU
as the JAX package's own tests run them (tests/test_ops.py,
tests/test_attention_kernel.py).

Each plain version gets the same numpy inputs as the JAX function
(``jax.vjp`` for the backward, at dropout rate 0: the TPU's bits are not
reproduced); all comparisons are float32.  At rate 0.1 each plain
backward is held against torch autograd through its plain forward with
the same seed.  The CUDA kernels themselves run only on a GPU
(tests/test_torch_cuda.py, chip_smoke.py); here are also the pure gates
that choose K1's and K4's bodies from the shape, held against the
kernels' own choice on the card."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cpc_audio_tpu.ops.pallas.attention import fused_causal_attention
from cpc_audio_tpu.ops.pallas.rnn import gru_scan_pallas
from cpc_audio_tpu_torch.ops import causal_attention as ca
from cpc_audio_tpu_torch.ops import _build, dropout, gru, lstm


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


# ---- K4: GRU recurrence -----------------------------------------------------

def _gru_inputs(rng, B, T, H):
    xp = rng.randn(B, T, 3 * H).astype(np.float32)
    w_hh = (rng.randn(3 * H, H) * 0.3).astype(np.float32)   # torch (3H, H)
    b_hh = (rng.randn(3 * H) * 0.1).astype(np.float32)
    h0 = (rng.randn(B, H) * 0.1).astype(np.float32)
    return xp, w_hh, b_hh, h0


@pytest.mark.parametrize("B,T,H", [(3, 16, 8), (2, 24, 32)])
def test_gru_ref_matches_pallas_interpret(B, T, H):
    xp, w_hh, b_hh, h0 = _gru_inputs(np.random.RandomState(B * 10 + H),
                                     B, T, H)
    ys_j, hT_j = gru_scan_pallas(jnp.asarray(xp), jnp.asarray(w_hh.T),
                                 jnp.asarray(b_hh), jnp.asarray(h0), True)
    ys, hT = gru.gru_scan_ref(_t(xp), _t(w_hh), _t(b_hh), _t(h0))
    # f32 both sides; only the summation order of h . W differs
    np.testing.assert_allclose(ys.numpy(), np.asarray(ys_j), atol=1e-5)
    np.testing.assert_allclose(hT.numpy(), np.asarray(hT_j), atol=1e-5)


@pytest.mark.parametrize("B,T,H", [(3, 16, 8), (2, 12, 32)])
def test_gru_grads_match_pallas_vjp(B, T, H):
    """dx_proj, dW_hh, db_hh and dh0 of the autograd ``gru`` (the plain
    forward and the plain reverse scan on the CPU) against ``jax.vjp`` of
    ``gru_scan_pallas`` in interpret mode, for cotangents on ys and hT."""
    rng = np.random.RandomState(B + T + H)
    xp, w_hh, b_hh, h0 = _gru_inputs(rng, B, T, H)
    dys = rng.randn(B, T, H).astype(np.float32)
    dhT = rng.randn(B, H).astype(np.float32)
    _, vjp = jax.vjp(lambda a, w, b, h: gru_scan_pallas(a, w, b, h, True),
                     jnp.asarray(xp), jnp.asarray(w_hh.T), jnp.asarray(b_hh),
                     jnp.asarray(h0))
    dx_j, dwt_j, db_j, dh0_j = vjp((jnp.asarray(dys), jnp.asarray(dhT)))
    args = [_t(a).requires_grad_(True) for a in (xp, w_hh, b_hh, h0)]
    ys, hT = gru.gru(*args)
    torch.autograd.backward((ys, hT), (_t(dys), _t(dhT)))
    want = (dx_j, np.asarray(dwt_j).T, db_j, dh0_j)
    for name, a, w in zip(("dx_proj", "dW_hh", "db_hh", "dh0"), args, want):
        # f32; sums over B*T in another order (as tests/test_ops.py)
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w), atol=2e-4,
                                   rtol=1e-3, err_msg=name)


def test_gru_bwd_ref_is_autograd_of_the_plain_forward():
    """The reverse scan's dx_proj and dghn against torch autograd through
    the differentiable plain forward: dgh = (dr, dz, dghn) is d/d(h .
    W_hh^T + b_hh), i.e. the gradient of b_hh per step, and (dr, dz) are
    dx_proj's first two thirds."""
    rng = np.random.RandomState(5)
    B, T, H = 2, 7, 8
    xp, w_hh, b_hh, h0 = (_t(a).requires_grad_(True)
                          for a in _gru_inputs(rng, B, T, H))
    dys = _t(rng.randn(B, T, H))
    ys, _, gates, ghn = gru.gru_scan_ref(xp, w_hh, b_hh, h0,
                                         save_residuals=True)
    (ys * dys).sum().backward()
    dx, dghn, dh0 = gru.gru_bwd_ref(gates.detach(), ghn.detach(),
                                    h0.detach(), ys.detach(), dys,
                                    w_hh.detach(), torch.zeros(B, H))
    assert dghn.shape == (B, T, H)
    torch.testing.assert_close(dx, xp.grad, atol=1e-5, rtol=1e-5)
    dgh = torch.cat([dx[..., :2 * H], dghn], dim=-1)
    torch.testing.assert_close(dgh.sum(dim=(0, 1)), b_hh.grad, atol=1e-5,
                               rtol=1e-5)
    torch.testing.assert_close(dh0, h0.grad, atol=1e-5, rtol=1e-5)


def test_gru_wrapper_runs_ref_on_cpu():
    args = [_t(a) for a in _gru_inputs(np.random.RandomState(0), 2, 5, 8)]
    before = (gru.gru_fwd.launches, gru.gru_bwd.launches)
    for got, want in zip(gru.gru_fwd(*args, save_residuals=True),
                         gru.gru_scan_ref(*args, save_residuals=True)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    xp, w, b, h0 = (a.requires_grad_(True) for a in args)
    ys, hT = gru.gru(xp, w, b, h0)
    ys.sum().backward()
    assert (gru.gru_fwd.launches, gru.gru_bwd.launches) == before


# ---- K1 and K4: which body runs ----------------------------------------------

# (forward, backward) body of K1 and of K4 by (H, dtype): the 16-CTA
# cluster bodies of K1 at H 512 and 768 in both dtypes (with part of W_hh
# streamed from L2 at 768, and in float32, whose W_hh travels as two bf16
# planes, at 512 too), the forward of both on 8 CTAs at H 128 and 16 at
# 256, their backward on 8 at both, the grid body (W_hh split over every
# SM) at every other H past 256
_BF, _F32 = torch.bfloat16, torch.float32
_BODIES = {
    (128, _BF): ("cluster", "cluster", "cluster", "cluster"),
    (128, _F32): ("cluster", "cluster", "cluster", "cluster"),
    (256, _BF): ("cluster", "cluster", "cluster", "cluster"),
    (256, _F32): ("cluster", "cluster", "cluster", "cluster"),
    (384, _BF): ("grid", "grid", "grid", "grid"),
    (384, _F32): ("grid", "grid", "grid", "grid"),
    (512, _BF): ("cluster", "cluster", "grid", "grid"),
    (512, _F32): ("cluster", "cluster", "grid", "grid"),
    (768, _BF): ("cluster", "cluster", "grid", "grid"),
    (768, _F32): ("cluster", "cluster", "grid", "grid"),
    (1024, _BF): ("grid", "grid", "grid", "grid"),
    (1024, _F32): ("grid", "grid", "grid", "grid"),
    (2048, _BF): ("grid", "grid", "grid", "grid"),
    (2048, _F32): ("grid", "grid", "grid", "grid"),
}


@pytest.mark.parametrize("H,dtype", sorted(_BODIES, key=str))
def test_recurrent_bodies_by_width_and_dtype(H, dtype):
    """K1's and K4's forward and backward pick their body from (H, dtype)
    alone, before any launch (no card needed), and every cluster layout
    fits a CTA's shared memory; the rows and grid bodies have none of the
    cluster's."""
    want = _BODIES[(H, dtype)]
    assert (lstm.fwd_body(H, dtype), lstm.bwd_body(H, dtype),
            gru.fwd_body(H, dtype), gru.bwd_body(H, dtype)) == want
    for body, smem in ((want[0], lstm.fwd_smem(H, dtype)),
                       (want[1], lstm.bwd_smem(H, dtype)),
                       (want[2], gru.fwd_smem(H, dtype))):
        assert (0 < smem <= _build.SMEM_LIMIT) == (body == "cluster")


def test_lstm_768_layouts_stream_part_of_w_hh():
    """At H 768 a CTA's bf16 slice of W_hh (192 gate rows by 768, 295 KB)
    is larger than its shared memory: both cluster layouts hold part of it
    in registers and shared memory and stream the rest, and the 8-CTA
    and the unstreamed 16-CTA backward layouts would not fit."""
    C, KS, RK, SK, D, NP = lstm.FWD_CLUSTER[768]
    assert C == 16 and 192 * 768 * 2 > _build.SMEM_LIMIT
    assert RK + SK < 768 // 16 // KS            # some k-steps streamed
    RK, SK, D = lstm.BWD_STREAM[768]
    assert RK + SK < 4 * 48 // 16
    assert lstm.CLUSTER[768] == 16
    for cluster in (8, 16):
        assert lstm.cluster_smem(768, 4, _BF, 5 * 8 + 2 * 2, cluster) \
            > _build.SMEM_LIMIT


# ---- K5: causal attention with a dense bias ---------------------------------

def _attn_inputs(rng, N, S, dk):
    q, k, v = (rng.randn(N, S, dk).astype(np.float32) for _ in range(3))
    bias = (rng.randn(N, S, S) * 0.5).astype(np.float32)
    return q, k, v, bias


@pytest.mark.parametrize("S", [20, 116, 128])
def test_causal_attention_matches_pallas_interpret(S):
    """Forward and vjp at rate 0: out, dq, dk, dv, dbias.  S = 20 and 116
    are padded inside the JAX kernel (to 24 and 128); the port takes S as
    it is."""
    N, dk = 8, 8
    rng = np.random.RandomState(S)
    q, k, v, bias = _attn_inputs(rng, N, S, dk)
    dout = rng.randn(N, S, dk).astype(np.float32)
    seed = jnp.zeros((1,), jnp.float32)
    out_j, vjp = jax.vjp(
        lambda *a: fused_causal_attention(*a, seed, 0.0, True),
        *(jnp.asarray(a) for a in (q, k, v, bias)))
    grads_j = vjp(jnp.asarray(dout))
    out = ca.causal_attention_ref(*(_t(a) for a in (q, k, v, bias)))
    # f32 both sides; softmax sums in another order
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=2e-5)
    grads = ca.causal_attention_bwd_ref(*(_t(a) for a in (q, k, v, bias)),
                                        _t(dout))
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), grads, grads_j):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-5,
                                   err_msg=name)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_causal_attention_bwd_regenerates_the_forward_mask(rate):
    """The plain backward equals torch autograd through the plain forward
    with the same seed and layer; dbias is exactly 0 above the diagonal,
    even where the bias holds large values there."""
    N, S, dk = 4, 24, 8
    rng = np.random.RandomState(7)
    q, k, v, bias = (_t(a).requires_grad_(True)
                     for a in _attn_inputs(rng, N, S, dk))
    with torch.no_grad():
        bias += 50.0 * torch.ones(S, S).triu(1)
    dout = _t(rng.randn(N, S, dk))
    seed = torch.tensor([99])
    out = ca.causal_attention_ref(q, k, v, bias, rate, seed, layer=1)
    (out * dout).sum().backward()
    got = ca.causal_attention_bwd_ref(q.detach(), k.detach(), v.detach(),
                                      bias.detach(), dout, rate, seed,
                                      layer=1)
    for name, g, t in zip(("dq", "dk", "dv", "dbias"), got, (q, k, v, bias)):
        torch.testing.assert_close(g, t.grad, atol=1e-5, rtol=1e-5,
                                   msg=name)
    assert torch.count_nonzero(got[3] * torch.ones(S, S).triu(1)) == 0
    # the autograd entry point on the CPU runs the same two plain versions
    q2, k2, v2, b2 = (t.detach().clone().requires_grad_(True)
                      for t in (q, k, v, bias))
    before = (ca.causal_attention_fwd.launches,
              ca.causal_attention_bwd.launches)
    out2 = ca.causal_attention(q2, k2, v2, b2, rate, seed, layer=1)
    torch.testing.assert_close(out2, out, rtol=0, atol=0)
    (out2 * dout).sum().backward()
    for g, t in zip(got, (q2, k2, v2, b2)):
        torch.testing.assert_close(t.grad, g, rtol=0, atol=0)
    assert (ca.causal_attention_fwd.launches,
            ca.causal_attention_bwd.launches) == before


def test_causal_attention_dropout_keeps_and_scales():
    """At rate 0.1 about 90 % of the causal probabilities are kept, each
    scaled by 1 / 0.9; layers and seeds draw different masks."""
    N, S = 64, 32
    seed = torch.tensor([3])
    mask = dropout.ar_attention_mask(seed, 0.1, 0, N, S, "cpu")
    causal = torch.ones(S, S, dtype=torch.bool).tril().expand(N, S, S)
    kept = mask[causal]
    values = torch.unique(kept)
    assert values.tolist() == [0.0, pytest.approx(1 / 0.9)]
    share = (kept > 0).float().mean().item()
    sigma = (0.09 / kept.numel()) ** 0.5
    assert abs(share - 0.9) < 5 * sigma
    assert not torch.equal(mask, dropout.ar_attention_mask(seed, 0.1, 1, N, S,
                                                           "cpu"))
    assert not torch.equal(mask, dropout.ar_attention_mask(
        torch.tensor([4]), 0.1, 0, N, S, "cpu"))
    # the forward at rate 0.1 is the rate-0 probabilities times the mask
    q, k, v, bias = (_t(a) for a in _attn_inputs(np.random.RandomState(1),
                                                 N, S, 8))
    p = ca._probs(q, k, bias)
    torch.testing.assert_close(ca.causal_attention_ref(q, k, v, bias, 0.1,
                                                       seed),
                               (p * mask) @ v, atol=1e-5, rtol=1e-5)


def test_causal_attention_refuses_dropout_without_a_seed():
    q = torch.zeros(2, 8, 4)
    b = torch.zeros(2, 8, 8)
    with pytest.raises(ValueError, match="needs a seed"):
        ca.causal_attention(q, q, q, b, rate=0.1)
    with pytest.raises(ValueError, match=r"not in \[0, 1\)"):
        ca.causal_attention(q, q, q, b, rate=1.0, seed=torch.zeros(1).long())
