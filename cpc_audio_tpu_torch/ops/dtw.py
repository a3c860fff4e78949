"""Batched DTW on the device: one anti-diagonal at a time over all pairs
(cpc_audio_tpu/ops/dtw_jax.py:24-93).

Plain PyTorch: the JAX package writes this in jnp, not as a Pallas
kernel, and its own default is the native host DTW (``native/dtw.cc``,
``ops/native.dtw_batch``), so the port keeps it plain until a profile
shows that ABX on the device matters.  All P pairs advance one
anti-diagonal a step, vectorised across pairs and the diagonal's cells.

The path length of the normalisation (the host kernel backtracks the
warping path) is carried forward: the backtrack's choice of predecessor
is a function of the cost cells (diagonal preferred, then left, else up),
so ``plen[i, j] = 1 + plen[pred(i, j)]`` through the same recurrence gives
the backtracked length exactly.  Unlike the JAX scan, which keeps every
diagonal, only each pair's final cell is kept, as its diagonal passes.
"""

from __future__ import annotations

import torch

_INF = float("inf")


def dtw_batch_device(dist: torch.Tensor, sx: torch.Tensor,
                     sy: torch.Tensor) -> torch.Tensor:
    """dist (P, S1, S2) float32; sx, sy (P,) valid lengths (>= 1), on
    dist's device.  Returns (P,) normalised DTW costs."""
    P, S1, S2 = dist.shape
    dev = dist.device
    dist = dist.float()
    sx = sx.to(dev, torch.int64)
    sy = sy.to(dev, torch.int64)
    i_idx = torch.arange(S1, device=dev)
    d_final = sx + sy - 2
    row_final = (sx - 1)[:, None]
    inf_col = torch.full((P, 1), _INF, device=dev)
    zero_col = torch.zeros((P, 1), device=dev)

    def shift(x, fill):          # x[i - 1] aligned at i
        return torch.cat([fill, x[:, :-1]], dim=1)

    prev_cost = torch.full((P, S1), _INF, device=dev)
    prev2_cost = prev_cost.clone()
    prev_plen = torch.zeros((P, S1), device=dev)
    prev2_plen = prev_plen.clone()
    final_cost = torch.zeros(P, device=dev)
    final_plen = torch.ones(P, device=dev)
    for d in range(S1 + S2 - 1):
        j_idx = d - i_idx
        valid = (j_idx >= 0) & (j_idx < S2)
        jc = j_idx.clamp(0, S2 - 1)
        d_diag = dist.gather(2, jc[None, :, None].expand(P, S1, 1))[..., 0]
        up = shift(prev_cost, inf_col)        # cost[i - 1, j]
        left = prev_cost                      # cost[i, j - 1]
        diag = shift(prev2_cost, inf_col)     # cost[i - 1, j - 1]
        is_start = ((i_idx == 0) & (j_idx == 0))[None, :]
        best = torch.minimum(torch.minimum(up, left), diag)
        cost = d_diag + torch.where(is_start, 0.0, best)
        take_diag = (diag <= left) & (diag <= up)
        plen = torch.where(take_diag, shift(prev2_plen, zero_col),
                           torch.where(left <= up, prev_plen,
                                       shift(prev_plen, zero_col))) + 1.0
        plen = torch.where(is_start, 1.0, plen)
        cost = torch.where(valid[None, :], cost, _INF)
        plen = torch.where(valid[None, :], plen, 0.0)
        done = d_final == d
        final_cost = torch.where(done, cost.gather(1, row_final)[:, 0],
                                 final_cost)
        final_plen = torch.where(done, plen.gather(1, row_final)[:, 0],
                                 final_plen)
        prev2_cost, prev_cost = prev_cost, cost
        prev2_plen, prev_plen = prev_plen, plen
    return final_cost / final_plen


def dtw_pairwise_device(dist_mat: torch.Tensor, sx, sy,
                        symmetric: bool) -> torch.Tensor:
    """(N1, N2, S1, S2) distances -> (N1, N2) normalised DTW, the contract
    of ``native.dtw_batch``: when ``symmetric`` the diagonal is 0 and the
    lower triangle mirrors the upper."""
    N1, N2, S1, S2 = dist_mat.shape
    dev = dist_mat.device
    sx = torch.as_tensor(sx, device=dev).to(torch.int64)
    sy = torch.as_tensor(sy, device=dev).to(torch.int64)
    out = dtw_batch_device(dist_mat.reshape(N1 * N2, S1, S2),
                           sx.repeat_interleave(N2), sy.repeat(N1)
                           ).reshape(N1, N2)
    if symmetric:
        upper = torch.ones((N1, N2), dtype=torch.bool, device=dev).triu(1)
        out = torch.where(upper, out, 0.0)
        out = out + out.T
    return out
