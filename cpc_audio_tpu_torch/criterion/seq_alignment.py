"""CTC prefix beam search, label-chain collapsing and PER alignment
(cpc_audio_tpu/criterion/seq_alignment.py:27-190).

The beam search and Needleman-Wunsch route through the native C++ host
library (``native/beam_search.cc``, bound by ``ops/native.py``) when it is
built, with the pure-Python versions kept as the fallback and the golden
semantics; ``collapse_label_chain_padded`` is the device-side,
static-shape collapse that feeds the CTC criterion.
"""

from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..ops import native


# ---------------------------------------------------------------------------
# Label-chain collapsing
# ---------------------------------------------------------------------------

def collapse_label_chain(labels: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Remove consecutive repeats of each row of ``labels (N, T)`` on the
    host: returns (padded (N, max size) int64, sizes (N,))."""
    labels = np.asarray(labels)
    N, T = labels.shape
    keep = np.concatenate(
        [np.ones((N, 1), bool), labels[:, 1:] != labels[:, :-1]], axis=1)
    sizes = keep.sum(axis=1).astype(np.int64)
    max_size = int(sizes.max()) if N else 0
    out = np.zeros((N, max_size), np.int64)
    for i in range(N):
        out[i, :sizes[i]] = labels[i][keep[i]]
    return out, sizes


def collapse_label_chain_padded(labels: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Remove consecutive repeats of each row of ``labels (B, T)`` on the
    device, at a static shape: returns (targets (B, T), paddings (B, T)
    float32), the collapsed labels left-packed, zeros after them, and
    paddings 1.0 past each row's collapsed length."""
    B, T = labels.shape
    keep = torch.ones_like(labels, dtype=torch.bool)
    keep[:, 1:] = labels[:, 1:] != labels[:, :-1]
    pos = torch.cumsum(keep, dim=1) - 1                 # destination slot
    pos = torch.where(keep, pos, torch.full_like(pos, T))   # dropped -> T
    targets = labels.new_zeros((B, T + 1))
    targets.scatter_(1, pos, labels)
    sizes = keep.sum(dim=1)
    paddings = (torch.arange(T, device=labels.device)[None, :]
                >= sizes[:, None]).float()
    return targets[:, :T], paddings


# ---------------------------------------------------------------------------
# CTC prefix beam search
# ---------------------------------------------------------------------------

def beam_search_py(score_preds: np.ndarray, n_keep: int, blank_label: int
                   ) -> List[Tuple[float, List[int]]]:
    """Pure-Python CTC prefix beam search over ``score_preds (T, P)``
    posterior probabilities: the ``n_keep`` best (score, labels), best
    first.  The beams' probabilities are Python floats (double), as the
    native kernel's: in float32 (NumPy 2 keeps a float32 row's products
    float32) they underflow to 0 after some 60 frames of ~0.05 each and
    the ranking is lost."""
    T, P = score_preds.shape
    beams: Sequence[Tuple[int, ...]] = [()]
    pb_prev = {(): 1.0}
    pnb_prev = {(): 0.0}
    all_preds: List[Tuple[float, Tuple[int, ...]]] = [(1.0, ())]

    for t in range(T):
        pb_t: dict = {}
        pnb_t: dict = {}
        row = np.asarray(score_preds[t], np.float64).tolist()
        for b in beams:
            pb_t.setdefault(b, 0.0)
            pnb_t.setdefault(b, 0.0)
            if b:
                pnb_t[b] += pnb_prev[b] * row[b[-1]]
            pb_t[b] = (pnb_prev[b] + pb_prev[b]) * row[blank_label]
            pbb, pnbb = pb_prev[b], pnb_prev[b]
            for c in range(P):
                if c == blank_label:
                    continue
                b_ = b + (c,)
                if b_ not in pb_t:
                    pb_t[b_] = 0.0
                    pnb_t[b_] = 0.0
                if b and b[-1] == c:
                    pnb_t[b_] += pbb * row[c]
                else:
                    pnb_t[b_] += (pbb + pnbb) * row[c]
        all_preds = sorted(((pb_t[b] + pnb_t[b], b) for b in pb_t),
                           key=lambda x: (x[0], x[1]), reverse=True)
        beams = [b for _, b in all_preds[:n_keep]]
        pb_prev, pnb_prev = pb_t, pnb_t

    return [(s, list(b)) for s, b in all_preds[:n_keep]]


def beam_search(score_preds: np.ndarray, n_keep: int, blank_label: int
                ) -> List[Tuple[float, List[int]]]:
    """The native beam search where the library is built, else
    :func:`beam_search_py`."""
    if native.available():
        return native.beam_search(np.ascontiguousarray(score_preds,
                                                       np.float32),
                                  n_keep, blank_label)
    return beam_search_py(score_preds, n_keep, blank_label)


# ---------------------------------------------------------------------------
# Needleman-Wunsch PER
# ---------------------------------------------------------------------------

def needleman_wunsch_align_score(seq1, seq2, d: float, m: float, r: float,
                                 normalize: bool = True) -> float:
    """Global alignment score, O(N1 N2), rows vectorised with numpy."""
    seq1 = np.asarray(seq1)
    seq2 = np.asarray(seq2)
    N1, N2 = len(seq1), len(seq2)
    prev = np.arange(N2 + 1, dtype=np.float64) * d
    for i in range(N1):
        match = np.where(seq2 == seq1[i], r, m)
        cur = np.empty(N2 + 1, np.float64)
        cur[0] = (i + 1) * d
        diag = prev[:-1] + match
        # cur[j + 1] = max(diag[j], prev[j + 1] + d, cur[j] + d); the last
        # term is a serial prefix recurrence
        best = np.maximum(diag, prev[1:] + d)
        for j in range(N2):
            cur[j + 1] = max(best[j], cur[j] + d)
        prev = cur
    res = -prev[N2]
    if normalize:
        res /= float(N1)
    return res


def get_seq_per(seq_labels, detected_labels) -> float:
    """PER: the normalised alignment score with d = m = -1, r = 0."""
    if native.available():
        return native.needleman_wunsch(
            np.ascontiguousarray(seq_labels, np.int32),
            np.ascontiguousarray(detected_labels, np.int32))
    return needleman_wunsch_align_score(seq_labels, detected_labels,
                                        -1, -1, 0, normalize=True)


def _per_one(args):
    posterior, labels, blank_label, n_keep = args
    preds = beam_search(posterior, n_keep, blank_label)[0][1]
    return get_seq_per(labels, preds)


def get_per(data_iter, feature_fn, blank_label: int,
            n_keep_beam_search: int = 100, pool_size: int = 8) -> float:
    """Mean PER over ``data_iter``, which yields (batch, frame labels);
    ``feature_fn(batch)`` gives (B, S, P) posterior probabilities (numpy
    or a tensor).  The beam searches of a batch run on a process pool
    started with ``spawn``: a process that holds a CUDA context must not
    be forked."""
    total, n_items = 0.0, 0
    for data, labels in data_iter:
        posteriors = feature_fn(data)
        if isinstance(posteriors, torch.Tensor):
            posteriors = posteriors.detach().float().cpu().numpy()
        posteriors = np.asarray(posteriors)
        labels_np, sizes = collapse_label_chain(np.asarray(labels))
        jobs = [(posteriors[i], labels_np[i, :sizes[i]], blank_label,
                 n_keep_beam_search) for i in range(posteriors.shape[0])]
        if pool_size > 1 and len(jobs) > 1:
            ctx = multiprocessing.get_context("spawn")
            with ProcessPoolExecutor(max_workers=pool_size,
                                     mp_context=ctx) as ex:
                values = list(ex.map(_per_one, jobs))
        else:
            values = [_per_one(j) for j in jobs]
        total += float(np.sum(values))
        n_items += len(jobs)
    return total / max(n_items, 1)
