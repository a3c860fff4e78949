"""LSTM recurrence over a whole window: the K1 kernel and its plain version.

Counterpart of ``cpc_audio_tpu/ops/pallas/rnn.py`` ``lstm_scan_pallas``
(forward only; the backward kernel comes with the training path).  The
input projection is hoisted out of the recurrence by the caller
(models/ar.py), so only ``h . W_hh^T`` is serial.  ``w_hh`` is in torch's
``(4H, H)`` layout, gate order i, f, g, o; ``x_proj`` already includes
``b_ih + b_hh``.  State and gate math are float32 whatever the input
dtype; outputs are rounded to the input dtype.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build

_NAME = "lstm_fwd"


def lstm_scan_ref(x_proj: torch.Tensor, w_hh: torch.Tensor,
                  h0: torch.Tensor, c0: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain time loop (models/ar.py:106-116 of the JAX package) with the
    kernel's float32 state.  Returns (ys (B,T,H), hT (B,H), cT (B,H))."""
    H = h0.shape[-1]
    xp = x_proj.float()
    w_t = w_hh.float().t()
    h, c = h0.float(), c0.float()
    ys = []
    for t in range(x_proj.shape[1]):
        g = xp[:, t] + h @ w_t
        i, f, gg, o = g.split(H, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
        h = torch.sigmoid(o) * torch.tanh(c)
        ys.append(h)
    return (torch.stack(ys, dim=1).to(x_proj.dtype), h.to(h0.dtype),
            c.to(c0.dtype))


def lstm_fwd(x_proj: torch.Tensor, w_hh: torch.Tensor, h0: torch.Tensor,
             c0: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x_proj (B, T, 4H), w_hh (4H, H), h0/c0 (B, H), one dtype.

    CPU tensors run :func:`lstm_scan_ref`; CUDA tensors launch the kernel
    (csrc/lstm_fwd.cu) and add one to ``lstm_fwd.launches``."""
    if not _build.runs_kernel(_NAME, x_proj, w_hh, h0, c0):
        return lstm_scan_ref(x_proj, w_hh, h0, c0)
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
    _build.require(B > 0 and T > 0 and 0 < H <= 2048 and H % 8 == 0, _NAME,
                   f"B={B}, T={T}, H={H} out of range (H % 8 == 0, <= 2048)")
    _build.require(w_hh.data_ptr() % 16 == 0, _NAME,
                   "w_hh must be 16-byte aligned (4 elements are read at "
                   "once)")
    ys = torch.empty((B, T, H), dtype=x_proj.dtype, device=x_proj.device)
    hT = torch.empty_like(h0)
    cT = torch.empty_like(c0)
    lib = _build.library()
    with torch.cuda.device(x_proj.device):
        status = lib.cpc_lstm_fwd(
            x_proj.data_ptr(), w_hh.data_ptr(), h0.data_ptr(), c0.data_ptr(),
            ys.data_ptr(), hT.data_ptr(), cT.data_ptr(), B, T, H,
            _build.DTYPE_CODES[x_proj.dtype], _build.stream(x_proj.device))
    _build.check(status, _NAME)
    lstm_fwd.launches += 1
    return ys, hT, cT


lstm_fwd.launches = 0
