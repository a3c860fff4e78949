"""Causal attention with Shaw relative positions: the K2 kernels and their
plain versions.

Counterpart of ``cpc_audio_tpu/ops/pallas/head_attention.py``
``fused_relpos_attention`` and its custom VJP.  q, k, v are
``(K, n_batch*S, D)`` with ``D = nheads*dk``, straight out of the
K-batched projections; ``krel`` is ``(K, dk, S)``.  Per (k, batch row,
head)::

    s[i, j] = (q_i . k_j + q_i . krel[:, j - i + S - 1]) / sqrt(dk),  j <= i
    o_i = (softmax_j(s[i]) * dropout[i]) . v

``j - i + S - 1`` is the JAX kernel's skew ``(j - i - 1) mod S`` on the
causal region.  The JAX kernel pads S to a multiple of 128 for the TPU's
lane rotate; these take S as it is.  Dropout (training) drops the
probabilities with the counter-based bits of ``ops/dropout.py``, keyed on
(k, batch row, head, i, j).

:func:`relpos_attention` is the differentiable entry point: its forward
runs the K2 forward kernel, counted in ``relpos_attention.launches``, its
backward the K2 backward kernels, counted in
``relpos_attention_bwd.launches``; each call also counts under its body in
the function's ``body_launches``.  CPU tensors take the plain versions.

Two bodies, by shape (:func:`fwd_body`, :func:`bwd_body`, mirrored by the
C exports ``cpc_relpos_attention_{fwd,bwd}_body``), the same kernels:

- "tc", at every S <= 4096 and dk <= 512 in both dtypes: the tensor-core
  body (csrc/relpos_attention_tc_fwd.cu, csrc/relpos_attention_tc_bwd.cu,
  on K5's mma.sync tiles): one block per (query tile, head) in the
  forward, the Shaw bias from the window product q . krel[:, window] of
  each tile pair; the backward in a row pass (statistics, dq), a column
  pass (dk, dv) and a diagonal pass (dkrel's partial windows, summed in a
  fixed order), with no (S, S) tile anywhere.  Float32 operands run as
  split bf16 planes (three in the forward, two in the backward):
  :func:`relpos_attention_split` and :func:`relpos_attention_bwd_split`
  write that arithmetic plainly.  Past dk 256 (DKP 512, the heads of
  ``--hiddenEncoder`` 2056-4096) the tiles are K5's 16 rows, all four
  warps on them, each forming the window product, q . k^T and do . v^T
  over its quarter of dk, the partials summed in a fixed order
  (``causal_attention.quarter_sum``).
- "cluster", dk 513-4096 (``--hiddenEncoder`` 4104-32768): the DKP 512
  kernels on thread-block clusters of ceil(dk / 512) CTAs, CTA c on dk
  columns [512 c, 512 c + 512), its warps' partial sums over dk summed in
  the CTA and then over the cluster, CTA 0 + 1 + ..., through distributed
  shared memory (csrc/relpos_attention_tc.cuh); the split arithmetic sums
  the 128-column quarters of each 512-column slab, then the slabs, in
  that order (``causal_attention.quarter_sum``).

:func:`supported` gives the (S, dk) the kernels take, without a card.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from . import _build, causal_attention, dropout, ffn

_NAME = "relpos_attention_fwd"
_BWD_NAME = "relpos_attention_bwd"
# the longest sequence the kernels are checked at on the card (S 4084 and
# 4096 in tests/test_torch_cuda.py and chip_smoke.py; --sizeWindow 655360,
# 41 s windows, gives 4084 anchors).  Nothing in the tensor-core body is
# sized by S but its O(N S dk) scratch
MAX_S = 4096
# dk columns a CTA of the cluster body, and the widest head: 8 CTAs, the
# portable cluster size (dk 4096 is --hiddenEncoder 32768, whose 12 heads'
# 4 D^2 weights alone pass the card's 80 GB)
SLAB = 512
MAX_DK = 8 * SLAB


def supported(S: int, dk: int) -> Optional[str]:
    """Why the kernels refuse a sequence length S and head width dk, or
    None: S <= 4096, the longest checked on the card, and dk <= 4096, in
    both dtypes: the tensor-core body to dk 512 (its operands padded to 32,
    64, 128, 256 or 512 columns), the cluster body past it (ceil(dk / 512)
    CTAs of 512 columns, at most 8)."""
    if not (0 < S <= MAX_S and 0 < dk <= MAX_DK):
        return (f"S={S}, dk={dk} out of range (0 < S <= {MAX_S}, "
                f"0 < dk <= {MAX_DK})")
    return None


def _heads(t: torch.Tensor, n_batch: int, nheads: int) -> torch.Tensor:
    """(K, M, D) -> (K, B, h, S, dk), float32."""
    K, M, D = t.shape
    return t.float().reshape(K, n_batch, M // n_batch, nheads,
                             D // nheads).transpose(2, 3)


def _unheads(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    K, B, h, S, dk = t.shape
    return t.transpose(2, 3).reshape(K, B * S, h * dk).to(dtype)


def _skew(S: int, device) -> torch.Tensor:
    """(S, S) rel-pos column (j - i - 1) mod S == j - i + S - 1 on j <= i."""
    i = torch.arange(S, device=device)[:, None]
    j = torch.arange(S, device=device)[None, :]
    return (j - i - 1) % S


def _probs(qh, kh, krel, S: int) -> torch.Tensor:
    """Causal softmax probabilities (K, B, h, S, S), float32."""
    K, B, h, _, dk = qh.shape
    qp = torch.einsum("kbhsd,kdr->kbhsr", qh, krel.float())
    bias = torch.gather(qp, -1, _skew(S, qh.device).expand(K, B, h, S, S))
    s = (qh @ kh.transpose(-1, -2) + bias) / math.sqrt(dk)
    causal = torch.ones(S, S, dtype=torch.bool, device=qh.device).tril()
    return torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)


def relpos_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         krel: torch.Tensor, n_batch: int, nheads: int,
                         rate: float = 0.0,
                         seed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: float32 scores and softmax; the dropped
    probabilities are rounded to the input dtype before ``. v``, as in the
    JAX kernel.  Differentiable by torch autograd."""
    K, M, _ = q.shape
    S = M // n_batch
    qh, kh, vh = (_heads(t, n_batch, nheads) for t in (q, k, v))
    p = _probs(qh, kh, krel, S)
    mask = dropout.attention_mask(seed, rate, K, n_batch, nheads, S,
                                  q.device)
    if mask is not None:
        p = p * mask
    return _unheads(p.to(q.dtype).float() @ vh, q.dtype)


def relpos_attention_bwd_ref(q, k, v, krel, dout, n_batch: int, nheads: int,
                             rate: float = 0.0,
                             seed: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, ...]:
    """Plain backward, the math of ``_bwd_kernel`` (head_attention.py
    :158-228): (dq, dk, dv) in the input dtype and dkrel (K, dk, S)
    float32, summed over batch rows and heads."""
    K, M, D = q.shape
    S, dk = M // n_batch, D // nheads
    dt = q.dtype
    qh, kh, vh, doh = (_heads(t, n_batch, nheads) for t in (q, k, v, dout))
    p = _probs(qh, kh, krel, S)
    mask = dropout.attention_mask(seed, rate, K, n_batch, nheads, S,
                                  q.device)
    pd = p if mask is None else p * mask
    dvh = pd.to(dt).float().transpose(-1, -2) @ doh
    dp = doh @ vh.transpose(-1, -2)
    if mask is not None:
        dp = dp * mask
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) / math.sqrt(dk)
    ds = ds.to(dt).float()
    # ds by krel column: U[i, r] = ds[i, j] at r = (j - i - 1) mod S, a
    # permutation of each row whose causal pairs take r = j - i + S - 1
    # and whose masked ones (ds exactly 0) the rest; so the rel-pos terms
    # are products with krel, and no (K, dk, S, S) tensor is formed
    U = torch.zeros_like(ds).scatter_(-1, _skew(S, q.device).expand_as(ds),
                                      ds)
    dqh = ds @ kh + U @ krel.float().transpose(-1, -2)[:, None, None]
    dkh = ds.transpose(-1, -2) @ qh
    dkrel = torch.einsum("kbhir,kbhid->kdr", U, qh)
    return (_unheads(dqh, dt), _unheads(dkh, dt), _unheads(dvh, dt), dkrel)


# bf16 planes a float32 operand of the tensor-core body: three in the
# forward (six split products a product), two in the backward (three), as
# K5's (csrc/relpos_attention_tc.cuh)
FWD_PLANES = causal_attention.FWD_PLANES
BWD_PLANES = causal_attention.BWD_PLANES
def tile_rows(dk: int, dtype: torch.dtype, backward: bool = False) -> int:
    """Query rows (and keys) a tile of the tensor-core body: 64 where a
    row's bf16 planes hold at most 128 values, else 32; 16 past dk 256
    (K5's ``Geom``; the cluster body's too)."""
    planes = 1 if dtype == torch.bfloat16 else (
        BWD_PLANES if backward else FWD_PLANES)
    return causal_attention.key_tile(dk, planes)


def fwd_body(S: int, dk: int, dtype: torch.dtype) -> str:
    """The body csrc/relpos_attention_tc_fwd.cu runs at a shape
    :func:`supported` takes, in both dtypes: "tc", the tensor-core tiles,
    to dk 512, else "cluster", the DKP 512 tiles on clusters of
    ceil(dk / 512) CTAs (``cpc_relpos_attention_fwd_body``: 1, 2)."""
    return "tc" if dk <= SLAB else "cluster"


def bwd_body(S: int, dk: int, dtype: torch.dtype) -> str:
    """The body csrc/relpos_attention_tc_bwd.cu runs: "tc" or "cluster",
    as :func:`fwd_body` (``cpc_relpos_attention_bwd_body``)."""
    return fwd_body(S, dk, dtype)


BODY_CODES = {"tc": 1, "cluster": 2}


def _planes(x: torch.Tensor, products: int) -> torch.Tensor:
    """x as the kernel's operand: float32 unchanged where its products are
    split (``products`` 3 or 6), else rounded to bf16 (the bf16 body's
    one plane, exact for bf16 inputs)."""
    return x.float() if products > 1 else x.to(torch.bfloat16).float()


def _mm(a: torch.Tensor, b: torch.Tensor, products: int) -> torch.Tensor:
    """a @ b as the body forms it: ``products`` split products of bf16
    planes (ffn.split_matmul), or one product of bf16 values summed in
    float32 (products 1: the operands are bf16 already)."""
    return ffn.split_matmul(a, b, products) if products > 1 else a @ b


def _mm_dk(a: torch.Tensor, b: torch.Tensor, products: int,
           dk: int) -> torch.Tensor:
    """:func:`_mm` of a product over dk (q . k^T, do . v^T, the window
    product), by quarters of dk past dk 256, as the four warps of a DKP
    512 tile form it, and past dk 512 by the quarters of each 512-column
    slab, the slabs then summed in order, as the CTAs of the cluster body
    do (``causal_attention.quarter_sum``)."""
    return causal_attention.quarter_sum(
        lambda x, y: _mm(x, y, products), a, b, dk)


def _tiled(t: torch.Tensor, n_batch: int, nheads: int, Sp: int):
    """(K, M, D) -> (K, B, h, Sp, dk) float32, rows past S zero (the
    kernel's zero-filled tile rows)."""
    th = _heads(t, n_batch, nheads)
    S = th.shape[3]
    return torch.nn.functional.pad(th, (0, 0, 0, Sp - S))


def krel_window(krel: torch.Tensor, S: int, i0: int, j0: int,
                T: int) -> torch.Tensor:
    """(K, dk, 2T): the krel columns r = j0 - i0 + S - T + c, c in [0, 2T),
    of query tile i0 and key tile j0, zero where r is outside [0, S) (only
    masked pairs read them): pair (i, j) reads column
    c = (j - j0) - (i - i0) + T - 1."""
    r = torch.arange(2 * T, device=krel.device) + (j0 - i0 + S - T)
    ok = ((r >= 0) & (r < S)).to(torch.float32)
    return krel.float()[:, :, r.clamp(0, S - 1)] * ok


def _skew_idx(T: int, device) -> torch.Tensor:
    """(T, T) window column c = j - i + T - 1 of tile pair (i, j)."""
    i = torch.arange(T, device=device)[:, None]
    j = torch.arange(T, device=device)[None, :]
    return j - i + T - 1


def relpos_attention_split(q, k, v, krel, n_batch: int, nheads: int,
                           rate: float = 0.0,
                           seed: Optional[torch.Tensor] = None,
                           products: Optional[int] = None) -> torch.Tensor:
    """The tensor-core forward's arithmetic written plainly
    (csrc/relpos_attention_tc_fwd.cu), tile by tile with the kernel's T and
    windows: for query tile [i0, i0 + T) and key tile [j0, j0 + T) the
    scores q . k^T and the window product QP = q . krel[:, window] (T x
    2T), the bias QP[i, j - i + T - 1] added in float32 (past dk 256 both
    products by quarters of dk, :func:`_mm_dk`).  In float32 every
    product is ``products`` split products of bf16 planes (6 from three,
    the kernel's; 3 from two, for comparison), with a running max,
    probabilities exp(s - running max) r, the partial output rescaled as
    the max moves and divided by the row sum at the end.  In bf16 one
    product of the bf16 operands; a first walk over the key tiles finds
    each row's max and sum, the second rounds the normalised p r to bf16
    before . v, and the output is rounded to bf16.  For tests and
    measurements only: the card runs the kernel."""
    dt = q.dtype
    P = products or (1 if dt == torch.bfloat16 else 6)
    K, M, D = q.shape
    S, dk = M // n_batch, D // nheads
    T = tile_rows(dk, dt)
    nq = -(-S // T)
    Sp = nq * T
    qh, kh, vh = (_planes(_tiled(t, n_batch, nheads, Sp), P)
                  for t in (q, k, v))
    kr = _planes(krel, P)
    mask = dropout.attention_mask(seed, rate, K, n_batch, nheads, S,
                                  q.device)
    if mask is not None:
        mask = torch.nn.functional.pad(mask, (0, Sp - S, 0, Sp - S))
    inv_sqrt = 1.0 / math.sqrt(dk)
    lead = (K, n_batch, nheads)
    idx = _skew_idx(T, q.device).expand(*lead, T, T)

    def scores(qt, kt):
        i0, j0 = qt * T, kt * T
        qs = qh[..., i0:i0 + T, :]
        win = krel_window(kr, S, i0, j0, T)[:, None, None]
        s = _mm_dk(qs, kh[..., j0:j0 + T, :].transpose(-1, -2), P, dk)
        s = (s + torch.gather(_mm_dk(qs, win, P, dk), -1, idx)) * inv_sqrt
        i = torch.arange(i0, i0 + T, device=q.device)[:, None]
        j = torch.arange(j0, j0 + T, device=q.device)[None, :]
        return s.masked_fill(j > i, float("-inf"))

    out = torch.zeros(*lead, Sp, dk, device=q.device)
    for qt in range(nq):
        i0 = qt * T
        m = torch.full((*lead, T, 1), float("-inf"), device=q.device)
        l = torch.zeros(*lead, T, 1, device=q.device)
        if P == 1:      # the rows' max and sum first
            for kt in range(qt + 1):
                s = scores(qt, kt)
                m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                l = l * torch.exp(m - m_new) + torch.exp(s - m_new).sum(
                    -1, keepdim=True)
                m = m_new
        o = torch.zeros(*lead, T, dk, device=q.device)
        for kt in range(qt + 1):
            j0 = kt * T
            s = scores(qt, kt)
            r = 1.0 if mask is None else mask[..., i0:i0 + T, j0:j0 + T]
            if P == 1:
                pd = (torch.exp(s - m) * (1.0 / l) * r).to(
                    torch.bfloat16).float()
                o = o + pd @ vh[..., j0:j0 + T, :]
                continue
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            rescale = torch.exp(m - m_new)
            e = torch.exp(s - m_new)
            l = l * rescale + e.sum(-1, keepdim=True)
            o = o * rescale + _mm(e * r, vh[..., j0:j0 + T, :], P)
            m = m_new
        out[..., i0:i0 + T, :] = o if P == 1 else o * (1.0 / l)
    return _unheads(out[..., :S, :], dt)


def relpos_attention_bwd_split(q, k, v, krel, dout, n_batch: int,
                               nheads: int, rate: float = 0.0,
                               seed: Optional[torch.Tensor] = None,
                               products: Optional[int] = None
                               ) -> Tuple[torch.Tensor, ...]:
    """The tensor-core backward's arithmetic written plainly
    (csrc/relpos_attention_tc_bwd.cu), in its three passes with the kernel's
    T and windows.  The row pass walks the key tiles twice: first for the
    rows' m, l and c = sum_j p dp (online), then for p, ds and
    dq = ds . k + U . krel[:, window]^T, with U the (T x 2T) unskewed ds,
    U[i, j - i + T - 1] = ds[i, j].  The column pass forms dk = ds^T . q
    and dv = (p r)^T . do.  The diagonal pass sums dkrel's window
    products q^T . U over the tile pairs of each tile diagonal qt - kt,
    then each krel column from the (at most two) windows that hold it.
    Past dk 256 the products over dk (s, dp, the window product) go by
    quarters of dk (:func:`_mm_dk`).
    In float32 every product is ``products`` split products (3 from two
    planes, the kernel's); in bf16 one product of bf16 operands, with ds
    and p r rounded to bf16 as the JAX kernel casts them.  Returns (dq,
    dk, dv) in the input dtype and dkrel (K, dk, S) float32.  For tests
    and measurements only."""
    dt = q.dtype
    P = products or (1 if dt == torch.bfloat16 else 3)
    K, M, D = q.shape
    S, dk = M // n_batch, D // nheads
    T = tile_rows(dk, dt, backward=True)
    nq = -(-S // T)
    Sp = nq * T
    qh, kh, vh, doh = (_planes(_tiled(t, n_batch, nheads, Sp), P)
                       for t in (q, k, v, dout))
    kr = _planes(krel, P)
    mask = dropout.attention_mask(seed, rate, K, n_batch, nheads, S,
                                  q.device)
    if mask is not None:
        mask = torch.nn.functional.pad(mask, (0, Sp - S, 0, Sp - S))
    inv_sqrt = 1.0 / math.sqrt(dk)
    lead = (K, n_batch, nheads)
    idx = _skew_idx(T, q.device).expand(*lead, T, T)
    dev = q.device

    def tile(qt, kt):
        """s (scaled, masked), dp r and r of tile pair (qt, kt)."""
        i0, j0 = qt * T, kt * T
        qs = qh[..., i0:i0 + T, :]
        win = krel_window(kr, S, i0, j0, T)[:, None, None]
        s = _mm_dk(qs, kh[..., j0:j0 + T, :].transpose(-1, -2), P, dk)
        s = (s + torch.gather(_mm_dk(qs, win, P, dk), -1, idx)) * inv_sqrt
        i = torch.arange(i0, i0 + T, device=dev)[:, None]
        j = torch.arange(j0, j0 + T, device=dev)[None, :]
        live = (j <= i) & (i < S)
        s = s.masked_fill(j > i, float("-inf"))
        dp = _mm_dk(doh[..., i0:i0 + T, :],
                    vh[..., j0:j0 + T, :].transpose(-1, -2), P, dk)
        r = None if mask is None else mask[..., i0:i0 + T, j0:j0 + T]
        return s, dp if r is None else dp * r, r, live, win

    # row pass, first walk: m, l, c per query row
    stats = []
    for qt in range(nq):
        m = torch.full((*lead, T, 1), float("-inf"), device=dev)
        l = torch.zeros(*lead, T, 1, device=dev)
        c = torch.zeros(*lead, T, 1, device=dev)
        for kt in range(qt + 1):
            s, dpr, _, _, _ = tile(qt, kt)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            rescale = torch.exp(m - m_new)
            e = torch.exp(s - m_new)
            l = l * rescale + e.sum(-1, keepdim=True)
            c = c * rescale + (e * dpr).sum(-1, keepdim=True)
            m = m_new
        inv_l = 1.0 / l
        stats.append((m, inv_l, c * inv_l))

    def ds_pd(qt, kt):
        s, dpr, r, live, win = tile(qt, kt)
        m, inv_l, c = stats[qt]
        p = torch.exp(s - m) * inv_l
        ds = torch.where(live, p * (dpr - c) * inv_sqrt, 0.0)
        pd = torch.where(live, p if r is None else p * r, 0.0)
        if P == 1:
            ds, pd = (x.to(torch.bfloat16).float() for x in (ds, pd))
        return ds, pd, win

    dqh = torch.zeros(*lead, Sp, dk, device=dev)
    dkh = torch.zeros(*lead, Sp, dk, device=dev)
    dvh = torch.zeros(*lead, Sp, dk, device=dev)
    windows = [torch.zeros(K, dk, 2 * T, device=dev) for _ in range(nq)]
    for qt in range(nq):
        i0 = qt * T
        for kt in range(qt + 1):
            j0 = kt * T
            ds, pd, win = ds_pd(qt, kt)
            U = torch.zeros(*lead, T, 2 * T, device=dev).scatter_(
                -1, idx, ds)
            dqh[..., i0:i0 + T, :] += (
                _mm(ds, kh[..., j0:j0 + T, :], P)
                + _mm(U, win.transpose(-1, -2), P))
            dkh[..., j0:j0 + T, :] += _mm(ds.transpose(-1, -2),
                                          qh[..., i0:i0 + T, :], P)
            dvh[..., j0:j0 + T, :] += _mm(pd.transpose(-1, -2),
                                          doh[..., i0:i0 + T, :], P)
            # the diagonal pass: window qt - kt, summed over b, h
            part = _mm(qh[..., i0:i0 + T, :].transpose(-1, -2), U, P)
            windows[qt - kt] += part.sum((1, 2))
    # each krel column r from the windows that hold it: window delta
    # starts at column S - (delta + 1) T
    dkrel = torch.zeros(K, dk, S, device=dev)
    for delta, w in enumerate(windows):
        r0 = S - (delta + 1) * T
        lo, hi = max(r0, 0), min(r0 + 2 * T, S)
        if lo < hi:
            dkrel[..., lo:hi] += w[..., lo - r0:hi - r0]
    return (_unheads(dqh[..., :S, :], dt), _unheads(dkh[..., :S, :], dt),
            _unheads(dvh[..., :S, :], dt), dkrel)


def _check_shapes(name: str, q, k, v, krel, n_batch: int, nheads: int,
                  others=()) -> Tuple[int, int]:
    K, M, D = q.shape
    _build.require(n_batch > 0 and M % n_batch == 0 and D % nheads == 0,
                   name, f"M={M}, D={D} vs n_batch={n_batch}, "
                   f"nheads={nheads}")
    S, dk = M // n_batch, D // nheads
    _build.require(all(tuple(t.shape) == tuple(q.shape) for t in (k, v)
                       + tuple(others))
                   and tuple(krel.shape) == (K, dk, S), name,
                   f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                   f"{tuple(v.shape)}, krel {tuple(krel.shape)}")
    _build.require(K > 0, name, f"K={K} out of range")
    why = supported(S, dk)
    _build.require(why is None, name, why or "")
    return S, dk


def _aligned(*ts: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The tensor-core body's operands, each 16-byte aligned: its bf16
    rows are read in place with 16-byte copies (a tensor off that
    alignment, a view into a larger one, is copied)."""
    return tuple(t if t.data_ptr() % 16 == 0 else t.clone() for t in ts)


def relpos_attention_fwd(q, k, v, krel, n_batch: int, nheads: int,
                         rate: float = 0.0,
                         seed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Forward: (K, n_batch*S, D) in the input dtype.  CPU tensors run
    :func:`relpos_attention_ref`; CUDA tensors launch the kernel of the
    body :func:`fwd_body` picks and add one to
    ``relpos_attention.launches`` and to ``relpos_attention.
    body_launches`` of that body."""
    dropout.check_rate(rate, seed, _NAME)
    if not _build.runs_kernel(_NAME, q, k, v, krel,
                              *dropout.seed_tensors(rate, seed)):
        return relpos_attention_ref(q, k, v, krel, n_batch, nheads, rate,
                                    seed)
    K = q.shape[0]
    S, dk = _check_shapes(_NAME, q, k, v, krel, n_batch, nheads)
    _build.check_inputs(_NAME, q.dtype, q=q, k=k, v=v, krel=krel)
    out = torch.empty_like(q)
    lib = _build.library()
    code = _build.DTYPE_CODES[q.dtype]
    body = fwd_body(S, dk, q.dtype)
    q, k, v = _aligned(q, k, v)
    with torch.cuda.device(q.device):
        # krel's padded bf16 planes and, in float32, the three planes of
        # q, k, v by head (csrc/relpos_attention_tc_fwd.cu)
        scratch = _build.scratch(lib.cpc_relpos_attention_fwd_tc_scratch(
            K, n_batch, S, nheads, dk, code), q.device)
        status = lib.cpc_relpos_attention_fwd_tc(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), krel.data_ptr(),
            out.data_ptr(), _build.ptr(scratch), K, n_batch, S, nheads, dk,
            *dropout.kernel_args(rate, seed), code, _build.stream(q.device))
    _build.check(status, _NAME)
    relpos_attention.launches += 1
    relpos_attention.body_launches[body] += 1
    return out


def relpos_attention_bwd(q, k, v, krel, dout, n_batch: int, nheads: int,
                         rate: float = 0.0,
                         seed: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, ...]:
    """Backward: (dq, dk, dv) in the input dtype, dkrel float32.  CPU
    tensors run :func:`relpos_attention_bwd_ref`; CUDA tensors launch the
    kernels of the body :func:`bwd_body` picks and add one to
    ``relpos_attention_bwd.launches`` and to its ``body_launches`` of that
    body."""
    dropout.check_rate(rate, seed, _BWD_NAME)
    if not _build.runs_kernel(_BWD_NAME, q, k, v, krel, dout,
                              *dropout.seed_tensors(rate, seed)):
        return relpos_attention_bwd_ref(q, k, v, krel, dout, n_batch,
                                        nheads, rate, seed)
    K = q.shape[0]
    S, dk = _check_shapes(_BWD_NAME, q, k, v, krel, n_batch, nheads,
                          (dout,))
    _build.check_inputs(_BWD_NAME, q.dtype, q=q, k=k, v=v, krel=krel,
                        dout=dout)
    lib = _build.library()
    code = _build.DTYPE_CODES[q.dtype]
    dq, dkk, dv = (torch.empty_like(q) for _ in range(3))
    dkrel = torch.empty((K, dk, S), dtype=torch.float32, device=q.device)
    body = bwd_body(S, dk, q.dtype)
    q, k, v, dout = _aligned(q, k, v, dout)
    with torch.cuda.device(q.device):
        # the rows' statistics, the diagonal pass's partial windows, krel's
        # padded planes and, in float32, the two planes of q, k, v and do
        # by head (csrc/relpos_attention_tc_bwd.cu)
        scratch = _build.scratch(lib.cpc_relpos_attention_bwd_tc_scratch(
            K, n_batch, S, nheads, dk, code), q.device)
        status = lib.cpc_relpos_attention_bwd_tc(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), krel.data_ptr(),
            dout.data_ptr(), dq.data_ptr(), dkk.data_ptr(), dv.data_ptr(),
            dkrel.data_ptr(), _build.ptr(scratch), K, n_batch, S, nheads, dk,
            *dropout.kernel_args(rate, seed), code, _build.stream(q.device))
    _build.check(status, _BWD_NAME)
    relpos_attention_bwd.launches += 1
    relpos_attention_bwd.body_launches[body] += 1
    return dq, dkk, dv, dkrel


relpos_attention_bwd.launches = 0
relpos_attention_bwd.body_launches = {"tc": 0, "cluster": 0}


class _RelposAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, krel, seed, n_batch, nheads, rate):
        ctx.save_for_backward(q, k, v, krel, seed)
        ctx.args = (n_batch, nheads, rate)
        return relpos_attention_fwd(q, k, v, krel, n_batch, nheads, rate,
                                    seed)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, krel, seed = ctx.saved_tensors
        n_batch, nheads, rate = ctx.args
        dq, dk, dv, dkrel = relpos_attention_bwd(
            q, k, v, krel, dout.to(q.dtype).contiguous(), n_batch, nheads,
            rate, seed)
        return dq, dk, dv, dkrel.to(krel.dtype), None, None, None, None


def relpos_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     krel: torch.Tensor, n_batch: int, nheads: int,
                     rate: float = 0.0,
                     seed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Differentiable attention, (K, n_batch*S, D) in the input dtype.

    ``rate > 0`` drops probabilities (training) with ``seed``, an int64
    tensor of shape (1,) on the inputs' device."""
    dropout.check_rate(rate, seed, _NAME)
    return _RelposAttention.apply(q, k, v, krel, seed, n_batch, nheads,
                                  rate)


relpos_attention.launches = 0
relpos_attention.body_launches = {"tc": 0, "cluster": 0}
