"""LSTM recurrence over a whole window: the K1 kernels and their plain
versions.

Counterpart of ``cpc_audio_tpu/ops/pallas/rnn.py`` ``lstm_scan_pallas``
and its custom VJP.  The input projection is hoisted out of the
recurrence by the caller (models/ar.py), so only ``h . W_hh^T`` is
serial.  ``w_hh`` is in torch's ``(4H, H)`` layout, gate order i, f, g, o;
``x_proj`` already includes ``b_ih + b_hh``.  State and gate math are
float32 whatever the input dtype; outputs are rounded to the input dtype.

* :func:`lstm_fwd` runs the recurrence (csrc/lstm_fwd.cu) and, for
  training, saves the gate activations and cell states (float32).  The
  kernel has three bodies, picked from H and the dtype before it
  launches: at H = 128 a thread-block cluster of 8 CTAs, at H = 256 (the
  default width), 512 and 768 one of 16, keeps W_hh on chip, split by
  unit, and all-gathers h each step (csrc/rnn_cluster_fwd.cuh; where a
  CTA's slice does not fit, at 768 in bf16 and at 512 and 768 in
  float32, part of it is streamed from L2 every step; float32 W_hh
  travels as two bf16 planes, :func:`lstm_scan_split`); at every other H
  past 256 the grid body splits W_hh by unit over all of the card's SMs
  in one cooperative launch (csrc/rnn_grid.cuh; in shared memory where a
  slice fits, else streamed every step) and all-gathers h through L2
  with a grid barrier a step; at the other H <= 256 (200, 104, ...) one
  block a batch row reads W_hh from L2 every step; :func:`fwd_body`
  mirrors that choice without a card;
* :func:`lstm_bwd` is the reverse scan (csrc/lstm_bwd.cu) giving float32
  dgates, dh0 and dc0.  The kernel has three bodies, picked the same
  way: at H = 128 and 256 a thread-block cluster of 8 CTAs keeps W_hh on
  chip (csrc/rnn_cluster.cuh), at H = 512 and 768 one of 16 (with the
  streamed remainder at 768 in bf16 and at both in float32, on W_hh's
  bf16 planes: :func:`lstm_bwd_split`); at every other H past 256 the
  grid body, which reduce-scatters each step's partial carries through
  L2; below, one block a batch row; :func:`bwd_body` mirrors that
  choice;
* :func:`lstm` is the differentiable entry point: a
  ``torch.autograd.Function`` over the two, with dW_hh = h_prev^T dgates
  as one matmul, as rnn.py:223-226.  It takes any H up to 8192: where the
  kernels' H % 8 does not hold it pads H with zero units (zero rows and
  columns of w_hh, zero x_proj columns and initial state) and slices them
  off.  A zero unit stays zero (i = f = o = 1/2, g = tanh(0) = 0, so c =
  h = 0) and its w_hh column is zero, so the real units never see it, and
  autograd drops the padded rows of every gradient.  The JAX package
  falls back to ``lax.scan`` at such H (models/ar.py:81-121); here the
  kernels still run.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build, ffn

_NAME = "lstm_fwd"
_BWD_NAME = "lstm_bwd"
MULTIPLE = 8          # the kernels' H: 4H whole 32-row tiles
# the widest H the kernels are checked at on the card (tests/test_torch_cuda.py,
# chip_smoke.py: --hiddenGar 8192).  Past 256 the grid bodies take every H
# whose units split into at most 72 a CTA over the card's SMs: 8192 on an
# H100 SXM's 132 (64 units on 128 CTAs) and on a 114-SM part (72 on 114)
MAX_H = 8192
# the backward's cluster body: CTAs a cluster by H (J = H / C units a CTA)
CLUSTER = {128: 8, 256: 8, 512: 16, 768: 16}
# the cluster bodies' layouts: each warp holds RK k-steps (16 rows of the
# product's depth) of its slice of W_hh in registers, SK in shared memory
# and streams the rest through a ring of D stages (cpc::rnn::Split).  The
# forward's by H: (C CTAs a cluster, KS parts of the H-deep product, RK,
# SK, D, NP parities of the A tile) (csrc/rnn_cluster_fwd.cuh FwdLayout;
# at 128 and 256 `with_resident_layout`, K4's too, at 512 and 768
# csrc/lstm_fwd.cu); the backward's past H 512: (RK, SK, D)
# (csrc/lstm_bwd.cu StreamLayout).  In bf16 W_hh is one plane (exact); in
# float32 it is two bf16 planes, hi and lo, whose k-steps follow one
# another (:func:`lstm_scan_split` writes that arithmetic)
FWD_CLUSTER = {128: (8, 4, 2, 0, 1, 2), 256: (16, 4, 4, 0, 1, 2),
               512: (16, 4, 0, 8, 1, 2), 768: (16, 2, 8, 10, 2, 1)}
BWD_STREAM = {768: (2, 4, 2)}
FWD_CLUSTER_F32 = {128: (8, 4, 4, 0, 1, 2), 256: (16, 4, 4, 4, 1, 2),
                   512: (16, 4, 3, 7, 2, 1), 768: (16, 2, 8, 10, 2, 1)}
BWD_STREAM_F32 = {512: (4, 8, 2), 768: (2, 4, 2)}


def padded_hidden(H: int) -> int:
    """H rounded up to the kernels' multiple."""
    return -(-H // MULTIPLE) * MULTIPLE


def supported(H: int) -> Optional[str]:
    """Why :func:`lstm` refuses a hidden width H (after padding), or
    None."""
    if not 0 < padded_hidden(H) <= MAX_H:
        return f"hidden width H={H} must be in [1, {MAX_H}]"
    return None


def _kernel_hidden(name: str, B: int, T: int, H: int) -> None:
    _build.require(B > 0 and T > 0 and H % MULTIPLE == 0
                   and supported(H) is None, name,
                   f"B={B}, T={T}, H={H} out of range (H % 8 == 0, <= "
                   f"{MAX_H})")


def cluster_smem(H: int, n_gates: int, dtype: torch.dtype, slot: int,
                 cluster: int = 8) -> int:
    """Shared memory of one CTA of the backward's cluster body of
    ``cluster`` CTAs, as ``cpc::rnn::Layout`` (csrc/rnn_cluster.cuh) lays
    it out: W_hh's n_gates * H / cluster rows (bf16 rows padded by 8), the
    A tile (bf16 hi and lo, or float32 padded by 4), two receive parities
    of ``cluster`` slots, one float32 state per unit and two residual
    slots of ``slot`` bytes per unit pair."""
    el = torch.empty((), dtype=dtype).element_size()
    mma = el < 4
    J, rows = H // cluster, 16
    GJ, pairs = n_gates * J, rows * J // 2

    def r16(n):
        return -(-n // 16) * 16
    w = r16(GJ * (H + 8 if mma else H) * el)
    a = r16((2 if mma else 1) * rows * (GJ + 8 if mma else GJ + 4) * el)
    return (w + a + 2 * cluster * rows * J * 4 + rows * J * 4
            + 2 * r16(slot * pairs))


def _r16(n: int) -> int:
    return -(-n // 16) * 16


def _planes(dtype: torch.dtype) -> int:
    """W_hh's bf16 planes in the cluster and grid bodies: 1 in bf16, 2 in
    float32."""
    return 1 if dtype == torch.bfloat16 else 2


def fwd_cluster_smem(H: int, G: int, dtype: torch.dtype,
                     layouts: dict) -> int:
    """Shared memory of one CTA of the forward's cluster body of G gates
    at H under ``layouts`` (:data:`FWD_CLUSTER` or its GRU
    counterpart), as ``FwdLayout`` (csrc/rnn_cluster_fwd.cuh) lays it
    out, 0 where it has none: NP parities of the A tile (h's bf16 hi and
    lo, 16 x H), each warp's 8 G gate rows by its SK resident k-steps
    (+ 8), its ring of D stages of 8 G x (16 + 8), the float32 partial
    gates the KS parts of the product leave one another (4 G (KS - 1) a
    lane) and an mbarrier a parity."""
    if H not in layouts:
        return 0
    C, KS, RK, SK, D, NP = layouts[H]
    J, R = H // C, 8 * G
    warps = J // 8 * KS
    streamed = _planes(dtype) * H // 16 // KS - RK - SK
    return (NP * C * (2 * 16 * J * 2) + warps * R * (SK * 16 + 8) * 2
            + (warps * D * R * 24 * 2 if streamed else 0)
            + (J // 8) * 4 * G * (KS - 1) * 32 * 4 + NP * 8)


def fwd_smem(H: int, dtype: torch.dtype) -> int:
    """Shared memory of one CTA of K1's forward cluster body at H
    (``cpc_lstm_fwd_smem``), 0 where it has none."""
    return fwd_cluster_smem(
        H, 4, dtype, FWD_CLUSTER if dtype == torch.bfloat16
        else FWD_CLUSTER_F32)


def bwd_smem(H: int, dtype: torch.dtype) -> int:
    """Shared memory of one CTA of the backward's cluster body at H
    (``cpc_lstm_bwd_smem``), 0 where it has none.  Past H 512 in bf16,
    and at H 512 and 768 in float32 (``StreamLayout``, csrc/lstm_bwd.cu):
    the A tile, one receive parity of 16 slots, the SK resident k-steps
    of the slice by H + 8 and each warp's ring of D stages of 16 x (J +
    8); below it :func:`cluster_smem`."""
    el = torch.empty((), dtype=dtype).element_size()
    streams = BWD_STREAM if dtype == torch.bfloat16 else BWD_STREAM_F32
    if H in streams:
        RK, SK, D = streams[H]
        J = H // 16
        streamed = _planes(dtype) * 4 * J // 16 - RK - SK
        return (_r16(2 * 16 * (4 * J + 8) * 2) + 16 * 16 * J * 4
                + SK * 16 * (H + 8) * 2
                + (16 * D * 16 * (J + 8) * 2 if streamed else 0))
    if H not in CLUSTER:
        return 0
    return cluster_smem(H, 4, dtype, 5 * 8 + 2 * el, CLUSTER[H])


def fwd_body(H: int, dtype: torch.dtype) -> str:
    """The body csrc/lstm_fwd.cu runs at hidden width H: "cluster", "grid"
    or "rows" (``cpc_lstm_fwd_body``: 1, 2, 0), from the shape alone."""
    smem = fwd_smem(H, dtype)
    if 0 < smem <= _build.SMEM_LIMIT:
        return "cluster"
    return "grid" if H >= GRID_MIN_H else "rows"


def bwd_body(H: int, dtype: torch.dtype) -> str:
    """The body csrc/lstm_bwd.cu runs at hidden width H: "cluster", "grid"
    or "rows" (``cpc_lstm_bwd_body``: 1, 2, 0), from the shape alone."""
    smem = bwd_smem(H, dtype)
    if 0 < smem <= _build.SMEM_LIMIT:
        return "cluster"
    return "grid" if H >= GRID_MIN_H else "rows"


BODY_CODES = {"rows": 0, "cluster": 1, "grid": 2}

# The grid bodies (csrc/rnn_grid.cuh, K1's and K4's): from H 257, 16 warps
# a CTA, a thread a unit pair of one batch row, so at most 32 rows a
# launch (larger batches in launches of that many; fewer past 32 units a
# CTA, up to 72), 128 KB of a CTA's shared memory for the forward's
# streamed stages of W_hh where its slice does not stay, the backward's
# carry in 2048 floats
GRID_MIN_H = 257
GRID_WARPS = 16
GRID_MAX_B = 32
GRID_MAX_J = 72
GRID_RING = 128 * 1024
GRID_CARRY = 2048


def grid_rows(J: int) -> int:
    """Batch rows a launch of a grid body takes at J units a CTA
    (``cpc::grid::rows_per_launch``)."""
    return min(GRID_MAX_B, GRID_WARPS * 32 // (J // 2) // 8 * 8)


def grid_shape(H: int, G: int, sms: int, B: int = GRID_MAX_B) -> dict:
    """How a grid body splits one launch at hidden width H with G gates
    over ``sms`` SMs (``cpc::grid::make_shape``): J units a CTA (even;
    the last CTA ragged) on ``ncta`` CTAs, KS 16-column groups of H, MT
    m16 tiles of a CTA's G J gate rows, the forward's MTW m-tiles a warp
    over MW warp groups and KW k-parts (MW KW <= 16 warps take part),
    ``rows`` batch rows a launch, NT
    n8 tiles of the widest launch of batch B, and whether it fits (J <=
    72 on ncta <= sms CTAs)."""
    J = -(-H // sms)
    J += J & 1
    MT = -(-G * J // 16)
    MTW = 2 if MT >= 2 else 1
    MW = -(-MT // MTW)
    ncta = -(-H // J)
    rows = grid_rows(J)
    return dict(J=J, ncta=ncta, KS=-(-H // 16), MT=MT, MTW=MTW, MW=MW,
                KW=GRID_WARPS // MW, rows=rows, NT=-(-min(B, rows) // 8),
                ok=J <= GRID_MAX_J and ncta <= sms)


def grid_smem(H: int, G: int, dtype: torch.dtype, sms: int,
              backward: bool) -> int:
    """Shared memory of a CTA of a grid body (``cpc_rnn_grid_smem``).
    Forward: W_hh's chunks (PL planes by the warp's MTW m-tiles by 16
    columns, bf16), MW x KS of them where they fit beside the KW k-parts'
    sums (32 rows by 16 MT + 4 float32 each), else 128 KB of streamed
    stages.  Backward: the KS chunks of PL planes by 16 MT rows by 16
    columns where they fit beside the dgates tile (bf16 hi and lo, 32 rows
    by 16 MT + 8), a float2 for each of the 512 threads and the carry
    (2048 float32), else each warp's ring of 4, 2 or 1 stages, a stage a
    chunk or, where 16 rings of whole chunks do not fit
    (:func:`grid_pieces`), half of one (ceil(MT / 2) m-tiles)."""
    s = grid_shape(H, G, sms)
    PL = _planes(dtype)
    if not backward:
        part = s["KW"] * GRID_MAX_B * (16 * s["MT"] + 4) * 4
        res = s["MW"] * s["KS"] * PL * s["MTW"] * 256 * 2
        return (res if res + part <= _build.SMEM_LIMIT else GRID_RING) + part
    res = s["KS"] * PL * s["MT"] * 256 * 2
    extra = grid_bwd_extra(s["MT"])
    if res + extra <= _build.SMEM_LIMIT:
        return res + extra
    return grid_ring(s["MT"], PL, grid_pieces(s["MT"], PL)) + extra


def grid_bwd_extra(MT: int) -> int:
    """The backward's shared memory beside W_hh: the dgates tile, the
    threads' partial sums and the carry
    (``cpc::grid::bwd_extra_bytes``)."""
    return (2 * GRID_MAX_B * (16 * MT + 8) * 2 + GRID_WARPS * 32 * 8
            + GRID_CARRY * 4)


def grid_ring(MT: int, PL: int, pieces: int) -> int:
    """Bytes of the streamed backward's 16 rings when a column group's
    chunk of MT m-tiles comes in ``pieces`` (``cpc::grid::
    bwd_ring_bytes``): a stage PL planes of ceil(MT / pieces) m-tiles, 4,
    2 or 1 stages a ring by its size."""
    mtp = -(-MT // pieces)
    stages = 4 if PL * mtp <= 4 else 2 if PL * mtp <= 8 else 1
    return GRID_WARPS * stages * PL * mtp * 256 * 2


def grid_pieces(MT: int, PL: int) -> int:
    """The pieces a streamed backward's chunk comes in
    (``cpc::grid::bwd_pieces``): 1 where 16 rings of whole chunks fit
    beside the rest, else 2 (K1 in float32 past J 44, K4 past J 58)."""
    fits = grid_ring(MT, PL, 1) + grid_bwd_extra(MT) <= _build.SMEM_LIMIT
    return 1 if fits else 2


def grid_scratch(B: int, H: int, G: int, dtype: torch.dtype, sms: int,
                 backward: bool) -> int:
    """Global scratch of a grid body at batch B (``cpc_lstm_fwd_scratch``
    and the others): W_hh packed once a call into each CTA's chunks, in
    the order and layout its shared memory takes them (PL bf16 planes:
    the forward's MW x KS chunks of MTW m-tiles by 16 columns, the
    backward's KS of all MT m-tiles by 16 columns), then the forward's
    exchange (two parities of h's bf16 hi and lo in mma fragment order,
    NT x KS x 32 lanes x 16 bytes) or the backward's partial carries (two
    parities of every CTA's KS x NT (16-column, 8-row) tiles in mma
    accumulator order, 32 lanes x 16 bytes each), sized for the widest
    launch (:func:`grid_rows`)."""
    s = grid_shape(H, G, sms, B)
    PL = _planes(dtype)
    if not backward:
        packed = s["ncta"] * s["MW"] * s["KS"] * PL * s["MTW"] * 256 * 2
        return packed + 2 * s["NT"] * s["KS"] * 32 * 16
    packed = s["ncta"] * s["KS"] * PL * s["MT"] * 256 * 2
    return packed + 2 * s["ncta"] * s["KS"] * s["NT"] * 32 * 16


def pad_gates(t: torch.Tensor, n_gates: int, H: int, Hp: int) -> torch.Tensor:
    """(..., n_gates * H) -> (..., n_gates * Hp): each gate's block
    zero-padded at its end (the layout of x_proj, w_hh's rows, b_hh)."""
    lead = t.shape[:-1]
    return F.pad(t.reshape(*lead, n_gates, H),
                 (0, Hp - H)).reshape(*lead, n_gates * Hp)


def pad_weight(w_hh: torch.Tensor, n_gates: int, H: int,
               Hp: int) -> torch.Tensor:
    """(n_gates * H, H) -> (n_gates * Hp, Hp), zero rows and columns."""
    return F.pad(w_hh.reshape(n_gates, H, H),
                 (0, Hp - H, 0, Hp - H)).reshape(n_gates * Hp, Hp)


def _acc(t: torch.Tensor) -> torch.dtype:
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _split_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the float32 cluster bodies form it: a and b each as
    bf16 hi + lo (``ffn.split_planes``), the 3 split products a_hi b_hi +
    a_lo b_hi + a_hi b_lo, each exact term by term and summed in float32
    (here each product apart)."""
    return ffn.split_matmul(a, b, 3)


def _scan(x_proj, w_hh, h0, c0, save_residuals: bool, matmul):
    """The forward time loop, h_{t-1} . W_hh^T as ``matmul``."""
    H = h0.shape[-1]
    acc = _acc(x_proj)
    xp = x_proj.to(acc)
    w_t = w_hh.to(acc).t()
    h, c = h0.to(acc), c0.to(acc)
    ys, gates, cs = [], [], []
    for t in range(x_proj.shape[1]):
        g = xp[:, t] + matmul(h, w_t)
        i, f, gg, o = g.split(H, dim=-1)
        i, f, gg, o = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(gg),
                       torch.sigmoid(o))
        c = f * c + i * gg
        h = o * torch.tanh(c)
        ys.append(h)
        if save_residuals:
            gates.append(torch.cat([i, f, gg, o], dim=-1))
            cs.append(c)
    out = (torch.stack(ys, dim=1).to(x_proj.dtype), h.to(h0.dtype),
           c.to(c0.dtype))
    if save_residuals:
        out += (torch.stack(gates, dim=1), torch.stack(cs, dim=1))
    return out


def _reverse_scan(gates, cs, c0, dys, w_hh, dhT, dcT, matmul):
    """The reverse time loop, dgates . W_hh as ``matmul``."""
    H = c0.shape[-1]
    acc = _acc(gates)
    w = w_hh.to(acc)
    dh, dc = dhT.to(acc), dcT.to(acc)
    dgs = []
    for t in range(gates.shape[1] - 1, -1, -1):
        i, f, gg, o = gates[:, t].split(H, dim=-1)
        c_prev = cs[:, t - 1] if t > 0 else c0.to(acc)
        c = f * c_prev + i * gg
        tc = torch.tanh(c)
        dh = dys[:, t].to(acc) + dh
        do_pre = dh * tc * o * (1.0 - o)
        dc = dc + dh * o * (1.0 - tc * tc)
        dgates = torch.cat([dc * gg * i * (1.0 - i),
                            dc * c_prev * f * (1.0 - f),
                            dc * i * (1.0 - gg * gg), do_pre], dim=-1)
        dgs.append(dgates)
        dh = matmul(dgates, w)
        dc = dc * f
    return torch.stack(dgs[::-1], dim=1), dh, dc


def lstm_scan_ref(x_proj: torch.Tensor, w_hh: torch.Tensor,
                  h0: torch.Tensor, c0: torch.Tensor,
                  save_residuals: bool = False):
    """Plain time loop (models/ar.py:106-116 of the JAX package) with the
    kernel's float32 state.  Returns (ys (B,T,H), hT (B,H), cT (B,H)), and
    with ``save_residuals`` also the float32 gate activations (B,T,4H) and
    cell states (B,T,H).  Float64 inputs are taken in float64 throughout:
    the exact version the float32 kernel is measured against."""
    return _scan(x_proj, w_hh, h0, c0, save_residuals, torch.matmul)


def lstm_bwd_ref(gates: torch.Tensor, cs: torch.Tensor, c0: torch.Tensor,
                 dys: torch.Tensor, w_hh: torch.Tensor, dhT: torch.Tensor,
                 dcT: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain reverse scan, line by line ``_lstm_bwd_kernel`` (rnn.py
    :97-134).  Returns float32 (dgates (B,T,4H), dh0 (B,H), dc0 (B,H)),
    float64 for float64 inputs."""
    return _reverse_scan(gates, cs, c0, dys, w_hh, dhT, dcT, torch.matmul)


def lstm_scan_split(x_proj: torch.Tensor, w_hh: torch.Tensor,
                    h0: torch.Tensor, c0: torch.Tensor,
                    save_residuals: bool = False):
    """The float32 cluster body's forward arithmetic written plainly (H
    128, 256, 512 and 768, csrc/rnn_cluster_fwd.cuh; the grid body's too,
    csrc/rnn_grid.cuh): :func:`lstm_scan_ref` with h_{t-1} .
    W_hh^T as 3 split products (:func:`_split_matmul`).  Float32 inputs;
    the same outputs.  For tests and measurements only: the card runs the
    kernel."""
    return _scan(x_proj, w_hh, h0, c0, save_residuals, _split_matmul)


def lstm_bwd_split(gates: torch.Tensor, cs: torch.Tensor, c0: torch.Tensor,
                   dys: torch.Tensor, w_hh: torch.Tensor, dhT: torch.Tensor,
                   dcT: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The float32 cluster body's backward arithmetic written plainly (H
    512 and 768, csrc/lstm_bwd.cu): :func:`lstm_bwd_ref` with dgates .
    W_hh as 3 split products (:func:`_split_matmul`).  Float32 inputs; the
    same outputs.  For tests and measurements only."""
    return _reverse_scan(gates, cs, c0, dys, w_hh, dhT, dcT, _split_matmul)


def lstm_fwd(x_proj: torch.Tensor, w_hh: torch.Tensor, h0: torch.Tensor,
             c0: torch.Tensor, save_residuals: bool = False):
    """x_proj (B, T, 4H), w_hh (4H, H), h0/c0 (B, H), one dtype.

    CPU tensors run :func:`lstm_scan_ref`; CUDA tensors launch the kernel
    (csrc/lstm_fwd.cu) and add one to ``lstm_fwd.launches`` and to
    ``lstm_fwd.body_launches`` of the body it runs (:func:`fwd_body`).
    Returns what :func:`lstm_scan_ref` returns."""
    if not _build.runs_kernel(_NAME, x_proj, w_hh, h0, c0):
        return lstm_scan_ref(x_proj, w_hh, h0, c0, save_residuals)
    B, T, G = x_proj.shape
    H = h0.shape[-1]
    _build.check_inputs(_NAME, x_proj.dtype, x_proj=x_proj, w_hh=w_hh, h0=h0,
                        c0=c0)
    _build.require(G == 4 * H and tuple(w_hh.shape) == (G, H)
                   and tuple(h0.shape) == (B, H)
                   and tuple(c0.shape) == (B, H), _NAME,
                   f"shapes x_proj {tuple(x_proj.shape)}, w_hh "
                   f"{tuple(w_hh.shape)}, h0 {tuple(h0.shape)}, c0 "
                   f"{tuple(c0.shape)}")
    _kernel_hidden(_NAME, B, T, H)
    _build.require_aligned(_NAME, w_hh=w_hh)
    dev = x_proj.device
    ys = torch.empty((B, T, H), dtype=x_proj.dtype, device=dev)
    hT = torch.empty_like(h0)
    cT = torch.empty_like(c0)
    gates = cs = None
    if save_residuals:
        gates = torch.empty((B, T, G), dtype=torch.float32, device=dev)
        cs = torch.empty((B, T, H), dtype=torch.float32, device=dev)
    lib = _build.library()
    code = _build.DTYPE_CODES[x_proj.dtype]
    body = fwd_body(H, x_proj.dtype)
    with torch.cuda.device(dev):
        # the cluster or grid body's exchange blocks, and in float32 W_hh's
        # bf16 planes (csrc/lstm_fwd.cu, csrc/rnn_grid.cuh)
        scratch = _build.scratch(lib.cpc_lstm_fwd_scratch(B, H, code), dev)
        barrier = _build.grid_barrier(dev) if body == "grid" else None
        status = lib.cpc_lstm_fwd(
            x_proj.data_ptr(), w_hh.data_ptr(), h0.data_ptr(), c0.data_ptr(),
            ys.data_ptr(), hT.data_ptr(), cT.data_ptr(),
            _build.ptr(gates), _build.ptr(cs), _build.ptr(scratch),
            _build.ptr(barrier), B, T, H, code, _build.stream(dev))
    _build.check(status, _NAME)
    lstm_fwd.launches += 1
    lstm_fwd.body_launches[body] += 1
    return (ys, hT, cT) + ((gates, cs) if save_residuals else ())


lstm_fwd.launches = 0
lstm_fwd.body_launches = {"cluster": 0, "grid": 0, "rows": 0}


def lstm_bwd(gates: torch.Tensor, cs: torch.Tensor, c0: torch.Tensor,
             dys: torch.Tensor, w_hh: torch.Tensor, dhT: torch.Tensor,
             dcT: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reverse scan: gates (B,T,4H), cs (B,T,H), dhT, dcT (B,H) float32;
    c0 (B,H), dys (B,T,H), w_hh (4H,H) in the compute dtype.  Returns
    float32 (dgates, dh0, dc0).

    CPU tensors run :func:`lstm_bwd_ref`; CUDA tensors launch the kernel
    (csrc/lstm_bwd.cu) and add one to ``lstm_bwd.launches`` and to
    ``lstm_bwd.body_launches`` of the body it runs (:func:`bwd_body`)."""
    if not _build.runs_kernel(_BWD_NAME, gates, cs, c0, dys, w_hh, dhT, dcT):
        return lstm_bwd_ref(gates, cs, c0, dys, w_hh, dhT, dcT)
    B, T, G = gates.shape
    H = G // 4
    _build.check_inputs(_BWD_NAME, torch.float32, gates=gates, cs=cs,
                        dhT=dhT, dcT=dcT)
    _build.check_inputs(_BWD_NAME, dys.dtype, c0=c0, dys=dys, w_hh=w_hh)
    _build.require(G == 4 * H and tuple(cs.shape) == (B, T, H)
                   and tuple(dys.shape) == (B, T, H)
                   and tuple(w_hh.shape) == (G, H)
                   and all(tuple(t.shape) == (B, H) for t in (c0, dhT, dcT)),
                   _BWD_NAME, f"shapes gates {tuple(gates.shape)}, cs "
                   f"{tuple(cs.shape)}, dys {tuple(dys.shape)}, w_hh "
                   f"{tuple(w_hh.shape)}")
    _kernel_hidden(_BWD_NAME, B, T, H)
    _build.require_aligned(_BWD_NAME, w_hh=w_hh)
    dev = gates.device
    dgates = torch.empty_like(gates)
    dh0 = torch.empty_like(dhT)
    dc0 = torch.empty_like(dcT)
    lib = _build.library()
    code = _build.DTYPE_CODES[dys.dtype]
    body = bwd_body(H, dys.dtype)
    with torch.cuda.device(dev):
        # the float32 cluster body's bf16 planes of W_hh; the grid body's
        # receive blocks (and planes) (csrc/lstm_bwd.cu, csrc/rnn_grid.cuh)
        scratch = _build.scratch(lib.cpc_lstm_bwd_scratch(B, H, code), dev)
        barrier = _build.grid_barrier(dev) if body == "grid" else None
        status = lib.cpc_lstm_bwd(
            gates.data_ptr(), cs.data_ptr(), c0.data_ptr(), dys.data_ptr(),
            w_hh.data_ptr(), dhT.data_ptr(), dcT.data_ptr(),
            dgates.data_ptr(), dh0.data_ptr(), dc0.data_ptr(),
            _build.ptr(scratch), _build.ptr(barrier), B, T, H, code,
            _build.stream(dev))
    _build.check(status, _BWD_NAME)
    lstm_bwd.launches += 1
    lstm_bwd.body_launches[body] += 1
    return dgates, dh0, dc0


lstm_bwd.launches = 0
lstm_bwd.body_launches = {"cluster": 0, "grid": 0, "rows": 0}


def _zeros_or(t: Optional[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(like, dtype=torch.float32) if t is None \
        else t.float().contiguous()


class _LSTM(torch.autograd.Function):
    """Forward K1 saving its residuals; backward K1 plus dW_hh."""

    @staticmethod
    def forward(ctx, x_proj, w_hh, h0, c0):
        train = any(ctx.needs_input_grad)
        out = lstm_fwd(x_proj, w_hh, h0, c0, save_residuals=train)
        ys, hT, cT = out[:3]
        if train:
            ctx.save_for_backward(out[3], out[4], ys, w_hh, h0, c0)
        return ys, hT, cT

    @staticmethod
    def backward(ctx, dys, dhT, dcT):
        gates, cs, ys, w_hh, h0, c0 = ctx.saved_tensors
        dys = torch.zeros_like(ys) if dys is None \
            else dys.to(ys.dtype).contiguous()
        dgates, dh0, dc0 = lstm_bwd(gates, cs, c0, dys, w_hh,
                                    _zeros_or(dhT, h0), _zeros_or(dcT, c0))
        B, T, G = gates.shape
        h_prev = torch.cat([h0[:, None], ys[:, :-1]], dim=1).float()
        # dW_hh[g, j] = sum_{b,t} dgates[b,t,g] h_prev[b,t,j]
        dw = dgates.reshape(B * T, G).t() @ h_prev.reshape(B * T, -1)
        return (dgates.to(ys.dtype), dw.to(w_hh.dtype), dh0.to(h0.dtype),
                dc0.to(c0.dtype))


def _recurrence(x_proj, w_hh, h0, c0):
    """:class:`_LSTM` where autograd records the call, else the forward
    alone, without residuals: under ``no_grad`` or ``inference_mode`` a
    Function still sees ``needs_input_grad`` on a float32 W_hh (the
    parameter itself) and would save them."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x_proj, w_hh, h0, c0)):
        return _LSTM.apply(x_proj, w_hh, h0, c0)
    return lstm_fwd(x_proj, w_hh, h0, c0)


def lstm(x_proj: torch.Tensor, w_hh: torch.Tensor, h0: torch.Tensor,
         c0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Differentiable recurrence: (ys, hT, cT) as :func:`lstm_fwd`, with a
    backward through :func:`lstm_bwd`; any H, padded to the kernels'
    multiple of 8 and sliced back.  Without autograd the forward saves no
    residuals."""
    H = h0.shape[-1]
    why = supported(H)
    _build.require(why is None, _NAME, why or "")
    Hp = padded_hidden(H)
    if Hp == H:
        return _recurrence(x_proj, w_hh, h0, c0)
    ys, hT, cT = _recurrence(pad_gates(x_proj, 4, H, Hp).contiguous(),
                             pad_weight(w_hh, 4, H, Hp).contiguous(),
                             F.pad(h0, (0, Hp - H)).contiguous(),
                             F.pad(c0, (0, Hp - H)).contiguous())
    return ys[..., :H].contiguous(), hT[..., :H], cT[..., :H]
