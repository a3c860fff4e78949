"""GRU recurrence over a whole window: the K4 kernels and their plain
versions.

Counterpart of ``cpc_audio_tpu/ops/pallas/rnn.py`` ``gru_scan_pallas``
and its custom VJP.  The input projection is hoisted out of the
recurrence by the caller (models/ar.py), so only ``h . W_hh^T + b_hh`` is
serial.  ``w_hh`` is in torch's ``(3H, H)`` layout, gate order r, z, n.
Unlike the LSTM's, ``b_hh`` cannot be folded into ``x_proj``: ``b_hn``
sits inside ``r * (h . W_hn^T + b_hn)`` (rnn.py:250-255), so the kernel
takes it as its own input and ``x_proj`` carries ``b_ih`` only.  State and
gate math are float32 whatever the input dtype; outputs are rounded to
the input dtype.

* :func:`gru_fwd` runs the recurrence (csrc/gru_fwd.cu) and, for
  training, saves the gates r, z, n (B, T, 3H) and ``ghn = h . W_hn^T +
  b_hn`` (B, T, H), both float32.  At H = 128 and 256 (the default
  width) it runs K1's cluster body, on 8 and 16 CTAs
  (csrc/rnn_cluster_fwd.cuh: W_hh on chip, split by unit, h all-gathered
  each step), past H 256
  K1's grid body (csrc/rnn_grid.cuh: W_hh split by unit over all of the
  card's SMs), ghn kept apart from r's product in both, at the other H
  one block a batch row: W_hh held in registers for the whole window
  where it fits (the resident body, float32 H 32-96 and bf16 also 160:
  the learning gate's H 64), else re-read from L2 every step (the rows
  body) (:func:`fwd_body`);
* :func:`gru_bwd` is the reverse scan (csrc/gru_bwd.cu) giving float32
  dx_proj = (dr, dz, dn), dghn and dh0, with K1's bodies (a thread-block
  cluster at H = 128 and 256, the grid body past 256,
  :func:`bwd_body`).  The gradient of ``h . W_hh^T + b_hh`` is dgh =
  (dr, dz, dghn): its first two thirds are dx_proj's, so only dghn is
  written.  In float32 the cluster forward and the grid bodies multiply
  on W_hh's two bf16 planes with 3 split products (:func:`gru_scan_split`,
  :func:`gru_bwd_split`);
* :func:`gru` is the differentiable entry point: a
  ``torch.autograd.Function`` over the two, with dW_hh = dgh^T h_prev and
  db_hh = sum dgh formed from dx_proj and dghn, as rnn.py:383-385.  It
  takes any H up to 8192: where the kernels' H % 32 does not hold it pads
  H with zero units (zero rows and columns of w_hh, zero b_hh, x_proj
  columns and h0) and slices them off.  A zero unit stays zero (r = z =
  1/2, n = tanh(0) = 0, h = z h = 0) and its w_hh column is zero, so the
  real units never see it, and autograd drops the padded rows of every
  gradient.  The JAX package falls back to ``lax.scan`` at such H
  (models/ar.py:81-121); here the kernels still run.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build, lstm
from .lstm import (GRID_MIN_H, MAX_H, _split_matmul, cluster_smem,
                   fwd_cluster_smem, pad_gates, pad_weight)

_NAME = "gru_fwd"
_BWD_NAME = "gru_bwd"
MULTIPLE = 32         # the kernels' H: 3H whole 32-row tiles
# the backward's cluster body: CTAs a cluster by H, as lstm.CLUSTER
CLUSTER = {128: 8, 256: 8}
# the forward's cluster body by H: K1's layouts at H 128 and 256, with a
# warp's 24 gate rows (csrc/rnn_cluster_fwd.cuh `with_resident_layout`)
FWD_CLUSTER = {H: lstm.FWD_CLUSTER[H] for H in (128, 256)}
FWD_CLUSTER_F32 = {H: lstm.FWD_CLUSTER_F32[H] for H in (128, 256)}


def padded_hidden(H: int) -> int:
    """H rounded up to the kernels' multiple."""
    return -(-H // MULTIPLE) * MULTIPLE


def supported(H: int) -> Optional[str]:
    """Why :func:`gru` refuses a hidden width H (after padding), or
    None."""
    if not 0 < padded_hidden(H) <= MAX_H:
        return f"hidden width H={H} must be in [1, {MAX_H}]"
    return None


def fwd_smem(H: int, dtype: torch.dtype) -> int:
    """Shared memory of one CTA of K4's forward cluster body at H
    (``cpc_gru_fwd_smem``; ``lstm.fwd_cluster_smem`` with 3 gates), 0
    where it has none."""
    return fwd_cluster_smem(
        H, 3, dtype, FWD_CLUSTER if dtype == torch.bfloat16
        else FWD_CLUSTER_F32)


# the forward's resident body by dtype: the widths whose W_hh fits one
# SM's registers (csrc/gru_fwd.cu `with_resident`; bf16 H 192 would take 144
# registers a thread and stays on the rows body)
RESIDENT = {torch.float32: (32, 64, 96), torch.bfloat16: (32, 64, 96, 160)}
# cpc_gru_fwd_body's codes of fwd_body's names (lstm.BODY_CODES and the
# resident body's)
BODY_CODES = {**lstm.BODY_CODES, "resident": 3}


def fwd_body(H: int, dtype: torch.dtype) -> str:
    """The body csrc/gru_fwd.cu runs at hidden width H: "cluster",
    "grid", "resident" or "rows" (``cpc_gru_fwd_body``: 1, 2, 3, 0), from
    the shape alone."""
    if 0 < fwd_smem(H, dtype) <= _build.SMEM_LIMIT:
        return "cluster"
    if H >= GRID_MIN_H:
        return "grid"
    return "resident" if H in RESIDENT.get(dtype, ()) else "rows"


def bwd_body(H: int, dtype: torch.dtype) -> str:
    """The body csrc/gru_bwd.cu runs at hidden width H: "cluster", "grid"
    or "rows" (``cpc_gru_bwd_body``: 1, 2, 0), from the shape alone."""
    if H in CLUSTER:
        el = torch.empty((), dtype=dtype).element_size()
        if cluster_smem(H, 3, dtype, 4 * 8 + 4 * el,
                        CLUSTER[H]) <= _build.SMEM_LIMIT:
            return "cluster"
    return "grid" if H >= GRID_MIN_H else "rows"


def _acc(t: torch.Tensor) -> torch.dtype:
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _scan(x_proj, w_hh, b_hh, h0, save_residuals: bool, matmul):
    """The forward time loop, h_{t-1} . W_hh^T as ``matmul``."""
    H = h0.shape[-1]
    acc = _acc(x_proj)
    xp = x_proj.to(acc)
    w_t = w_hh.to(acc).t()
    b = b_hh.to(acc)
    h = h0.to(acc)
    ys, gates, ghns = [], [], []
    for t in range(x_proj.shape[1]):
        gh = matmul(h, w_t) + b
        xr, xz, xn = xp[:, t].split(H, dim=-1)
        hr, hz, ghn = gh.split(H, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * ghn)
        h = (1.0 - z) * n + z * h
        ys.append(h)
        if save_residuals:
            gates.append(torch.cat([r, z, n], dim=-1))
            ghns.append(ghn)
    out = (torch.stack(ys, dim=1).to(x_proj.dtype), h.to(h0.dtype))
    if save_residuals:
        out += (torch.stack(gates, dim=1), torch.stack(ghns, dim=1))
    return out


def gru_scan_ref(x_proj: torch.Tensor, w_hh: torch.Tensor,
                 b_hh: torch.Tensor, h0: torch.Tensor,
                 save_residuals: bool = False):
    """Plain time loop (``_gru_fwd_kernel``, rnn.py:238-262) with the
    kernel's float32 state.  Returns (ys (B,T,H), hT (B,H)), and with
    ``save_residuals`` also the float32 gates (B,T,3H) and ghn (B,T,H).
    Float64 inputs are taken in float64 throughout: the exact version the
    float32 kernel is measured against."""
    return _scan(x_proj, w_hh, b_hh, h0, save_residuals, torch.matmul)


def gru_scan_split(x_proj: torch.Tensor, w_hh: torch.Tensor,
                   b_hh: torch.Tensor, h0: torch.Tensor,
                   save_residuals: bool = False):
    """The float32 cluster and grid bodies' forward arithmetic written
    plainly (csrc/rnn_cluster_fwd.cuh, csrc/rnn_grid.cuh):
    :func:`gru_scan_ref` with h_{t-1} . W_hh^T as 3
    split products (``lstm._split_matmul``).  Float32 inputs; the same
    outputs.  For tests and measurements only: the card runs the
    kernel."""
    return _scan(x_proj, w_hh, b_hh, h0, save_residuals, _split_matmul)


def _h_prev(h0: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """(B, T, H): h0 followed by ys[:, :-1], in the compute dtype."""
    return torch.cat([h0[:, None].to(ys.dtype), ys[:, :-1]], dim=1)


def _reverse_scan(gates, ghn, h0, ys, dys, w_hh, dhT, matmul):
    """The reverse time loop, dgh . W_hh as ``matmul``."""
    H = h0.shape[-1]
    acc = _acc(gates)
    w = w_hh.to(acc)
    h_prev = _h_prev(h0, ys).to(acc)
    dh = dhT.to(acc)
    dxs, dghns = [], []
    for t in range(gates.shape[1] - 1, -1, -1):
        r, z, n = gates[:, t].split(H, dim=-1)
        dh = dys[:, t].to(acc) + dh
        dz = dh * (h_prev[:, t] - n) * z * (1.0 - z)
        dn = dh * (1.0 - z) * (1.0 - n * n)
        dghn = dn * r
        dr = dn * ghn[:, t] * r * (1.0 - r)
        dxs.append(torch.cat([dr, dz, dn], dim=-1))
        dghns.append(dghn)
        dh = dh * z + matmul(torch.cat([dr, dz, dghn], dim=-1), w)
    return (torch.stack(dxs[::-1], dim=1), torch.stack(dghns[::-1], dim=1),
            dh)


def gru_bwd_ref(gates: torch.Tensor, ghn: torch.Tensor, h0: torch.Tensor,
                ys: torch.Tensor, dys: torch.Tensor, w_hh: torch.Tensor,
                dhT: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain reverse scan, line by line ``_gru_bwd_kernel`` (rnn.py
    :265-296), keeping dghn where the Pallas kernel keeps dgh.  Returns
    float32 (dx_proj (B,T,3H), dghn (B,T,H), dh0 (B,H)), float64 for
    float64 inputs."""
    return _reverse_scan(gates, ghn, h0, ys, dys, w_hh, dhT, torch.matmul)


def gru_bwd_split(gates: torch.Tensor, ghn: torch.Tensor, h0: torch.Tensor,
                  ys: torch.Tensor, dys: torch.Tensor, w_hh: torch.Tensor,
                  dhT: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The float32 grid body's backward arithmetic written plainly
    (csrc/rnn_grid.cuh): :func:`gru_bwd_ref` with dgh . W_hh as 3 split
    products (``lstm._split_matmul``).  Float32 inputs; the same outputs.
    For tests and measurements only."""
    return _reverse_scan(gates, ghn, h0, ys, dys, w_hh, dhT, _split_matmul)


def _check_hidden(name: str, B: int, T: int, H: int) -> None:
    _build.require(B > 0 and T > 0 and H % MULTIPLE == 0
                   and supported(H) is None, name,
                   f"B={B}, T={T}, H={H} out of range (H % 32 == 0, so "
                   f"that 3H is whole 32-row tiles; H <= {MAX_H})")


def gru_fwd(x_proj: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
            h0: torch.Tensor, save_residuals: bool = False):
    """x_proj (B, T, 3H), w_hh (3H, H), b_hh (3H,), h0 (B, H), one dtype.

    CPU tensors run :func:`gru_scan_ref`; CUDA tensors launch the kernel
    (csrc/gru_fwd.cu) and add one to ``gru_fwd.launches`` and to
    ``gru_fwd.body_launches`` of the body it runs (:func:`fwd_body`).
    Returns what :func:`gru_scan_ref` returns."""
    if not _build.runs_kernel(_NAME, x_proj, w_hh, b_hh, h0):
        return gru_scan_ref(x_proj, w_hh, b_hh, h0, save_residuals)
    B, T, G = x_proj.shape
    H = h0.shape[-1]
    _build.check_inputs(_NAME, x_proj.dtype, x_proj=x_proj, w_hh=w_hh,
                        b_hh=b_hh, h0=h0)
    _build.require(G == 3 * H and tuple(w_hh.shape) == (G, H)
                   and tuple(b_hh.shape) == (G,)
                   and tuple(h0.shape) == (B, H), _NAME,
                   f"shapes x_proj {tuple(x_proj.shape)}, w_hh "
                   f"{tuple(w_hh.shape)}, b_hh {tuple(b_hh.shape)}, h0 "
                   f"{tuple(h0.shape)}")
    _check_hidden(_NAME, B, T, H)
    _build.require_aligned(_NAME, w_hh=w_hh)
    dev = x_proj.device
    ys = torch.empty((B, T, H), dtype=x_proj.dtype, device=dev)
    hT = torch.empty_like(h0)
    gates = ghn = None
    if save_residuals:
        gates = torch.empty((B, T, G), dtype=torch.float32, device=dev)
        ghn = torch.empty((B, T, H), dtype=torch.float32, device=dev)
    lib = _build.library()
    code = _build.DTYPE_CODES[x_proj.dtype]
    body = fwd_body(H, x_proj.dtype)
    with torch.cuda.device(dev):
        # the cluster or grid body's exchange buffer (and in float32
        # W_hh's planes)
        scratch = _build.scratch(lib.cpc_gru_fwd_scratch(B, H, code), dev)
        barrier = _build.grid_barrier(dev) if body == "grid" else None
        status = lib.cpc_gru_fwd(
            x_proj.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
            h0.data_ptr(), ys.data_ptr(), hT.data_ptr(), _build.ptr(gates),
            _build.ptr(ghn), _build.ptr(scratch), _build.ptr(barrier), B, T,
            H, code, _build.stream(dev))
    _build.check(status, _NAME)
    gru_fwd.launches += 1
    gru_fwd.body_launches[body] += 1
    return (ys, hT) + ((gates, ghn) if save_residuals else ())


gru_fwd.launches = 0
gru_fwd.body_launches = {"cluster": 0, "grid": 0, "resident": 0, "rows": 0}


def gru_bwd(gates: torch.Tensor, ghn: torch.Tensor, h0: torch.Tensor,
            ys: torch.Tensor, dys: torch.Tensor, w_hh: torch.Tensor,
            dhT: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reverse scan: gates (B,T,3H), ghn (B,T,H) and dhT (B,H) float32;
    h0 (B,H), ys and dys (B,T,H), w_hh (3H,H) in the compute dtype.
    Returns float32 (dx_proj, dghn, dh0).

    CPU tensors run :func:`gru_bwd_ref`; CUDA tensors launch the kernel
    (csrc/gru_bwd.cu) and add one to ``gru_bwd.launches`` and to
    ``gru_bwd.body_launches`` of the body it runs (:func:`bwd_body`)."""
    if not _build.runs_kernel(_BWD_NAME, gates, ghn, h0, ys, dys, w_hh, dhT):
        return gru_bwd_ref(gates, ghn, h0, ys, dys, w_hh, dhT)
    B, T, G = gates.shape
    H = G // 3
    _build.check_inputs(_BWD_NAME, torch.float32, gates=gates, ghn=ghn,
                        dhT=dhT)
    _build.check_inputs(_BWD_NAME, dys.dtype, h0=h0, ys=ys, dys=dys,
                        w_hh=w_hh)
    _build.require(G == 3 * H and tuple(ghn.shape) == (B, T, H)
                   and tuple(ys.shape) == (B, T, H)
                   and tuple(dys.shape) == (B, T, H)
                   and tuple(w_hh.shape) == (G, H)
                   and tuple(h0.shape) == (B, H)
                   and tuple(dhT.shape) == (B, H), _BWD_NAME,
                   f"shapes gates {tuple(gates.shape)}, ghn "
                   f"{tuple(ghn.shape)}, ys {tuple(ys.shape)}, dys "
                   f"{tuple(dys.shape)}, w_hh {tuple(w_hh.shape)}")
    _check_hidden(_BWD_NAME, B, T, H)
    _build.require_aligned(_BWD_NAME, w_hh=w_hh)
    dev = gates.device
    dx = torch.empty_like(gates)
    dghn = torch.empty_like(ghn)
    dh0 = torch.empty_like(dhT)
    lib = _build.library()
    code = _build.DTYPE_CODES[dys.dtype]
    body = bwd_body(H, dys.dtype)
    with torch.cuda.device(dev):
        # the grid body's receive blocks (and in float32 W_hh's planes)
        scratch = _build.scratch(lib.cpc_gru_bwd_scratch(B, H, code), dev)
        barrier = _build.grid_barrier(dev) if body == "grid" else None
        status = lib.cpc_gru_bwd(
            gates.data_ptr(), ghn.data_ptr(), h0.data_ptr(), ys.data_ptr(),
            dys.data_ptr(), w_hh.data_ptr(), dhT.data_ptr(), dx.data_ptr(),
            dghn.data_ptr(), dh0.data_ptr(), _build.ptr(scratch),
            _build.ptr(barrier), B, T, H, code, _build.stream(dev))
    _build.check(status, _BWD_NAME)
    gru_bwd.launches += 1
    gru_bwd.body_launches[body] += 1
    return dx, dghn, dh0


gru_bwd.launches = 0
gru_bwd.body_launches = {"cluster": 0, "grid": 0, "rows": 0}


class _GRU(torch.autograd.Function):
    """Forward K4 saving its residuals; backward K4 plus dW_hh, db_hh."""

    @staticmethod
    def forward(ctx, x_proj, w_hh, b_hh, h0):
        train = any(ctx.needs_input_grad)
        out = gru_fwd(x_proj, w_hh, b_hh, h0, save_residuals=train)
        ys, hT = out[:2]
        if train:
            ctx.save_for_backward(out[2], out[3], ys, w_hh, h0)
        return ys, hT

    @staticmethod
    def backward(ctx, dys, dhT):
        gates, ghn, ys, w_hh, h0 = ctx.saved_tensors
        dys = torch.zeros_like(ys) if dys is None \
            else dys.to(ys.dtype).contiguous()
        dhT = torch.zeros_like(h0, dtype=torch.float32) if dhT is None \
            else dhT.float().contiguous()
        dx, dghn, dh0 = gru_bwd(gates, ghn, h0, ys, dys, w_hh, dhT)
        B, T, G = gates.shape
        H = G // 3
        h_prev = _h_prev(h0, ys).float().reshape(B * T, H)
        # dW_hh[g, j] = sum_{b,t} dgh[b,t,g] h_prev[b,t,j], where dgh =
        # (dr, dz, dghn) and (dr, dz) are dx's first two thirds
        drz = dx.reshape(B * T, G)[:, :2 * H]
        dghn = dghn.reshape(B * T, H)
        dw = torch.cat([drz.t() @ h_prev, dghn.t() @ h_prev])
        db = torch.cat([drz.sum(dim=0), dghn.sum(dim=0)])
        return (dx.to(ys.dtype), dw.to(w_hh.dtype), db.to(w_hh.dtype),
                dh0.to(h0.dtype))


def _recurrence(x_proj, w_hh, b_hh, h0):
    """:class:`_GRU` where autograd records the call, else the forward
    alone, without residuals (as ``lstm._recurrence``)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x_proj, w_hh, b_hh, h0)):
        return _GRU.apply(x_proj, w_hh, b_hh, h0)
    return gru_fwd(x_proj, w_hh, b_hh, h0)


def gru(x_proj: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
        h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable recurrence: (ys, hT) as :func:`gru_fwd`, with a
    backward through :func:`gru_bwd`; any H, padded to the kernels'
    multiple of 32 and sliced back.  Without autograd the forward saves no
    residuals."""
    H = h0.shape[-1]
    why = supported(H)
    _build.require(why is None, _NAME, why or "")
    Hp = padded_hidden(H)
    if Hp == H:
        return _recurrence(x_proj, w_hh, b_hh, h0)
    ys, hT = _recurrence(pad_gates(x_proj, 3, H, Hp).contiguous(),
                        pad_weight(w_hh, 3, H, Hp).contiguous(),
                        pad_gates(b_hh, 3, H, Hp).contiguous(),
                        F.pad(h0, (0, Hp - H)).contiguous())
    return ys[..., :H].contiguous(), hT[..., :H]
