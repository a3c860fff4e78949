"""ABX distances and group scoring (cpc_audio_tpu/eval/abx/
group_computation.py).

The host path is the port's own copy of the JAX package's (numpy
einsums; the DP in the native C++ DTW kernel, ``native/dtw.cc``, with a
pure-Python fallback).  ``on_device=True`` runs the same scores on a torch
device instead: the groups padded into shape buckets, their distances and
the anti-diagonal DTW of ``ops/dtw.py`` computed a bucket at a time
(:func:`_scores_on_device`), as the JAX package does on its device.
"""

from __future__ import annotations

import math
from typing import Callable, List, Tuple

import numpy as np
import torch

from ..._common import precision_policy, resolve_device
from ...ops import native


def get_distance_function_from_name(name: str) -> Callable:
    if name == "euclidian":
        return get_euclidian_distance_batch
    if name == "cosine":
        return get_cosine_distance_batch
    raise ValueError("Invalid distance mode")


def get_cosine_distance_batch(a1: np.ndarray, a2: np.ndarray,
                              epsilon: float = 1e-8) -> np.ndarray:
    """Angular distance acos(<a1,a2>)/pi; inputs pre-normalized
    (abx_group_computation.py:26-35).  Returns (N1, N2, S1, S2)."""
    prod = np.einsum("nsd,mtd->nmst", a1, a2, optimize=True)
    return (np.arccos(np.clip(prod, -1.0, 1.0)) / math.pi).astype(np.float32)


def get_euclidian_distance_batch(a1: np.ndarray, a2: np.ndarray) -> np.ndarray:
    """(N1, N2, S1, S2) pairwise frame euclidean distances
    (abx_group_computation.py:38-42)."""
    n1 = (a1 ** 2).sum(axis=2)  # (N1, S1)
    n2 = (a2 ** 2).sum(axis=2)  # (N2, S2)
    prod = np.einsum("nsd,mtd->nmst", a1, a2, optimize=True)
    sq = n1[:, None, :, None] + n2[None, :, None, :] - 2 * prod
    return np.sqrt(np.maximum(sq, 0.0)).astype(np.float32)


def _dtw_py(dist: np.ndarray, N: int, M: int) -> float:
    """Pure-python DTW fallback (dtw.pyx:40-77 semantics)."""
    cost = np.empty((N, M), np.float32)
    cost[0, 0] = dist[0, 0]
    for i in range(1, N):
        cost[i, 0] = dist[i, 0] + cost[i - 1, 0]
    for j in range(1, M):
        cost[0, j] = dist[0, j] + cost[0, j - 1]
    for i in range(1, N):
        for j in range(1, M):
            cost[i, j] = dist[i, j] + min(cost[i - 1, j], cost[i - 1, j - 1],
                                          cost[i, j - 1])
    i, j, path_len = N - 1, M - 1, 1
    while i > 0 and j > 0:
        up, left, diag = cost[i - 1, j], cost[i, j - 1], cost[i - 1, j - 1]
        if diag <= left and diag <= up:
            i, j = i - 1, j - 1
        elif left <= up:
            j -= 1
        else:
            i -= 1
        path_len += 1
    if i == 0:
        path_len += j
    if j == 0:
        path_len += i
    return float(cost[N - 1, M - 1]) / path_len


def dtw_batch(dist_mat: np.ndarray, sx: np.ndarray, sy: np.ndarray,
              symmetric: bool, on_device: bool = False,
              device=None) -> np.ndarray:
    """Batched normalised DTW; ignore_diag == symmetric, as at the
    reference's call sites.  ``on_device`` runs the anti-diagonal DTW of
    ``ops/dtw.py`` on ``device`` (default: the card, see
    ``resolve_device``) instead of the native host kernel."""
    if on_device:
        from ...ops.dtw import dtw_pairwise_device
        dev = resolve_device(device)
        # a writable copy: get_theta_group_dtw fills the diagonal in place
        return dtw_pairwise_device(
            torch.as_tensor(np.asarray(dist_mat, np.float32), device=dev),
            np.asarray(sx), np.asarray(sy), symmetric).cpu().numpy().copy()
    if native.available():
        return native.dtw_batch(dist_mat, sx, sy, symmetric)
    N1, N2 = dist_mat.shape[:2]
    out = np.zeros((N1, N2), np.float32)
    for i in range(N1):
        start = i if symmetric else 0
        for j in range(start, N2):
            if symmetric and i == j:
                continue
            out[i, j] = _dtw_py(dist_mat[i, j], sx[i], sy[j])
            if symmetric and i != j:
                out[j, i] = out[i, j]
    return out


def get_distance_group_dtw(a1, a2, size1, size2, ignore_diag=False,
                           symmetric=False,
                           distance_function=get_cosine_distance_batch,
                           on_device=False, device=None) -> np.ndarray:
    """Frame distances -> per-pair DTW costs (abx_group_computation.py:45-60).
    ignore_diag must equal symmetric (enforced by dtw_batch)."""
    distance_mat = distance_function(a1, a2)
    return dtw_batch(distance_mat, np.asarray(size1), np.asarray(size2),
                     symmetric, on_device=on_device, device=device)


def get_theta_group_dtw(a, b, x, sa, sb, sx, distance_function, symmetric,
                        on_device=False, device=None) -> float:
    """theta = P[d(x,a) < d(x,b)] + 0.5 P[=] over all pairs
    (abx_group_computation.py:63-90)."""
    assert a.shape[2] == b.shape[2] == x.shape[2]
    dxb = get_distance_group_dtw(x, b, sx, sb,
                                 distance_function=distance_function,
                                 on_device=on_device, device=device)
    dxa = get_distance_group_dtw(x, a, sx, sa, ignore_diag=symmetric,
                                 symmetric=symmetric,
                                 distance_function=distance_function,
                                 on_device=on_device, device=device)
    Nx, Na = dxa.shape
    _, Nb = dxb.shape
    if symmetric:
        n_pos = Na * (Na - 1)
        max_val = dxb.max()
        np.fill_diagonal(dxa, max_val + 1)
    else:
        n_pos = Na * Nx
    dxb_e = dxb[:, None, :]
    dxa_e = dxa[:, :, None]
    sc = (dxa_e < dxb_e).sum() + 0.5 * (dxa_e == dxb_e).sum()
    return float(sc) / (n_pos * Nb)


def loc_dtw(data, distance_function, symmetric, on_device=False,
            device=None):
    coords, (a_data, a_size), (b_data, b_size), (x_data, x_size) = data
    theta = get_theta_group_dtw(a_data, b_data, x_data, a_size, b_size,
                                x_size, distance_function, symmetric,
                                on_device=on_device, device=device)
    return coords, 1.0 - theta


def get_abx_scores_dtw_on_group(group_iterator, distance_function, symmetric,
                                on_device=False, device=None
                                ) -> Tuple[List[tuple], List[float], tuple]:
    """Score every group (abx_group_computation.py:110-129).

    Returns (coords_list, values_list, board_size); the dense aggregation
    happens in abx_cli.reduce_scores (the reference used a torch sparse
    tensor for the same bookkeeping).

    on_device=True scores the groups in shape-bucketed batches on
    ``device`` (default: the card; :func:`_scores_on_device`): a real
    .item file yields thousands of groups, and one launch sequence a
    group is launch-bound."""
    if on_device:
        return _scores_on_device(group_iterator, distance_function,
                                 symmetric, resolve_device(device))
    coords_list, values_list = [], []
    for group in group_iterator:
        coords, abx = loc_dtw(group, distance_function, symmetric)
        coords_list.append(coords)
        values_list.append(abx)
    return coords_list, values_list, group_iterator.get_board_size()


# --------------------------------------------------------------------------
# Batched on-device scoring
# --------------------------------------------------------------------------

# float32 distance cells a bucket chunk may hold, as the JAX package
_MAX_CELLS = 64 * 1024 * 1024


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _score_bucket_device(A, B, X, sa, sb, sx, symmetric: bool,
                         cosine: bool) -> torch.Tensor:
    """A (G, Na, S, D), B (G, Nb, S, D), X (G, Nx, S, D) float32, padded
    (an item is valid where its size is > 0), sizes (G, N) int: the (G,)
    ABX error rates 1 - theta, theta as in get_theta_group_dtw."""
    from ...ops.dtw import dtw_batch_device

    def dist(u, v):
        prod = torch.einsum("gnsd,gmtd->gnmst", u, v)
        if cosine:
            return torch.arccos(prod.clamp(-1.0, 1.0)) / math.pi
        nu = (u * u).sum(3)                            # (G, N, S)
        nv = (v * v).sum(3)
        sq = (nu[:, :, None, :, None] + nv[:, None, :, None, :]
              - 2.0 * prod)
        return sq.clamp(min=0.0).sqrt()

    def pair_dtw(u, v, su, sv):
        G, Nu, S, _ = u.shape
        Nv = v.shape[1]
        dm = dist(u, v).reshape(G * Nu * Nv, S, S)
        # padded items take size 1, so that the final cell is in range;
        # their scores are masked out of the count below
        suf = su.clamp(min=1)[:, :, None].expand(G, Nu, Nv)
        svf = sv.clamp(min=1)[:, None, :].expand(G, Nu, Nv)
        return dtw_batch_device(dm, suf.reshape(-1),
                                svf.reshape(-1)).reshape(G, Nu, Nv)

    dxa = pair_dtw(X, A, sx, sa)                       # (G, Nx, Na)
    dxb = pair_dtw(X, B, sx, sb)                       # (G, Nx, Nb)
    vx, va, vb = sx > 0, sa > 0, sb > 0
    wxa = vx[:, :, None] & va[:, None, :]
    if symmetric:                                      # the x set is the a set
        eye = torch.eye(dxa.shape[1], dxa.shape[2], dtype=torch.bool,
                        device=dxa.device)
        wxa = wxa & ~eye[None]
    lt = (dxa[:, :, :, None] < dxb[:, :, None, :]).float()
    eq = (dxa[:, :, :, None] == dxb[:, :, None, :]).float()
    w = wxa[:, :, :, None] & vb[:, None, None, :]
    sc = torch.where(w, lt + 0.5 * eq, 0.0).sum(dim=(1, 2, 3))
    na, nb, nx = va.sum(1), vb.sum(1), vx.sum(1)
    n_pos = na * (na - 1) if symmetric else na * nx
    denom = (n_pos * nb).clamp(min=1).float()
    return 1.0 - sc / denom


def _scores_on_device(group_iterator, distance_function, symmetric,
                      device: torch.device
                      ) -> Tuple[List[tuple], List[float], tuple]:
    """Shape-bucketed batched scoring on ``device``: the groups padded to
    bucketed shapes (one item count a group, the largest of its three
    roles rounded up to a multiple of 4; frame counts to a multiple of 8),
    up to _MAX_CELLS distance cells a chunk, the chunk count padded to a
    power of two, as the JAX package buckets them."""
    precision_policy()        # float32 products: TF32 off
    cosine = distance_function is get_cosine_distance_batch
    groups = list(group_iterator)
    coords_list = [g[0] for g in groups]
    values: List[float] = [0.0] * len(groups)
    buckets = {}
    for gi, (_, (a, sa), (b, sb), (x, sx)) in enumerate(groups):
        nt = _round_up(max(a.shape[0], b.shape[0], x.shape[0]), 4)
        key = (nt, _round_up(max(a.shape[1], b.shape[1], x.shape[1]), 8),
               a.shape[2])
        buckets.setdefault(key, []).append(gi)

    for (N, S, D), idxs in buckets.items():
        gmax = max(1, _MAX_CELLS // max(N * N * S * S, 1))
        for lo in range(0, len(idxs), gmax):
            chunk = idxs[lo:lo + gmax]
            G = len(chunk)
            Gp = G if G == gmax else 1 << (G - 1).bit_length()
            data = np.zeros((3, Gp, N, S, D), np.float32)
            sizes = np.zeros((3, Gp, N), np.int64)
            for ci, gi in enumerate(chunk):
                for r, (arr, size) in enumerate(groups[gi][1:]):
                    data[r, ci, :arr.shape[0], :arr.shape[1]] = arr
                    sizes[r, ci, :arr.shape[0]] = np.asarray(size)
            t = torch.from_numpy(data).to(device)
            sz = torch.from_numpy(sizes).to(device)
            out = _score_bucket_device(t[0], t[1], t[2], sz[0], sz[1],
                                       sz[2], symmetric, cosine)
            out = out.cpu().numpy()
            for ci, gi in enumerate(chunk):
                values[gi] = float(out[ci])
    return coords_list, values, group_iterator.get_board_size()
