"""CPCAR in LSTM mode (cpc_audio_tpu/models/ar.py:49-172).

The input projection for the whole window is one matmul hoisted out of
the recurrence (ar.py:75-77), with ``b_hh`` folded into it as ar.py:88
does; only ``h . W_hh^T`` runs inside the recurrence, in the K1 kernel
(ops/lstm.py), whose backward is the K1 backward kernel.  The hidden
carry is explicit: ``forward(x, hidden)`` returns ``(y, (h, c))`` with
each of ``h, c`` shaped (layers, B, H) and detached, like the reference's
carried state.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .._common import uniform
from ..ops.lstm import lstm

Hidden = Tuple[torch.Tensor, torch.Tensor]


class _LSTMLayer(nn.Module):
    """One LSTM layer, torch's nn.LSTM layout: weight_ih (4H, C),
    weight_hh (4H, H), gate order i, f, g, o."""

    def __init__(self, c_in: int, hidden: int,
                 generator: Optional[torch.Generator]):
        super().__init__()
        bound = 1.0 / math.sqrt(hidden)
        self.weight_ih = uniform((4 * hidden, c_in), bound, generator)
        self.weight_hh = uniform((4 * hidden, hidden), bound, generator)
        self.bias_ih = uniform((4 * hidden,), bound, generator)
        self.bias_hh = uniform((4 * hidden,), bound, generator)

    def forward(self, x: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor):
        dt = x.dtype
        bias = self.bias_ih.to(dt) + self.bias_hh.to(dt)
        x_proj = F.linear(x, self.weight_ih.to(dt), bias)   # (B, T, 4H)
        return lstm(x_proj.contiguous(), self.weight_hh.to(dt).contiguous(),
                    h0.to(dt).contiguous(), c0.to(dt).contiguous())


class CPCAR(nn.Module):
    """Multi-layer LSTM context network."""

    def __init__(self, dim_input: int, dim_output: int, num_layers: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dim_output = dim_output
        self.num_layers = num_layers
        for layer in range(num_layers):
            c_in = dim_input if layer == 0 else dim_output
            setattr(self, f"layer{layer}",
                    _LSTMLayer(c_in, dim_output, generator))

    def zero_state(self, batch: int, dtype: torch.dtype,
                   device: torch.device) -> Hidden:
        shape = (self.num_layers, batch, self.dim_output)
        return (torch.zeros(shape, dtype=dtype, device=device),
                torch.zeros(shape, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor, hidden: Optional[Hidden] = None
                ) -> Tuple[torch.Tensor, Hidden]:
        if hidden is None:
            hidden = self.zero_state(x.shape[0], x.dtype, x.device)
        hs, cs = [], []
        y = x
        for layer in range(self.num_layers):
            y, hT, cT = getattr(self, f"layer{layer}")(
                y, hidden[0][layer], hidden[1][layer])
            hs.append(hT)
            cs.append(cT)
        return y, (torch.stack(hs).detach(), torch.stack(cs).detach())
