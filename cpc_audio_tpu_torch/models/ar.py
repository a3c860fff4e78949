"""Recurrent context networks CPCAR (GRU, LSTM, RNN), NoAr and the
bidirectional GRUs BiDIRARTangled and BiDIRAR
(cpc_audio_tpu/models/ar.py:49-226).

The input projection for the whole window is one matmul hoisted out of
the recurrence (ar.py:75-77); only ``h . W_hh^T`` runs inside it:

* LSTM: ``b_hh`` is folded into the projection as ar.py:88 does, and the
  recurrence is the K1 kernel (ops/lstm.py);
* GRU: ``b_hh`` stays apart (``b_hn`` sits inside ``r * (.)``) and the
  recurrence is the K4 kernel (ops/gru.py);
* RNN (tanh): a plain time loop, as the JAX package has no kernel for it
  either (ar.py:117-121).

The hidden carry is explicit: ``forward(x, hidden)`` returns ``(y,
hidden_out)`` with a GRU/RNN state one (layers, B, H) tensor and an LSTM
state an ``(h, c)`` pair of them, detached like the reference's carried
state (ar.py:171).  ``CPCAR(reverse=True)`` (``--cpc_mode reverse``)
flips time before and after its layers.

The bidirectional ARs are library modules, as in the JAX package, whose
``--arMode`` builds neither: each direction is a GRU of width
``dim_output // 2`` on K4, and the two outputs are concatenated on the
channel axis.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from .._common import uniform
from ..ops.gru import gru
from ..ops.lstm import lstm

Hidden = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]
MODES = {"GRU": 3, "LSTM": 4, "RNN": 1}       # gates per mode


class _RecurrentLayer(nn.Module):
    """One layer in torch's nn.GRU / nn.LSTM / nn.RNN layout: weight_ih
    (G*H, C), weight_hh (G*H, H), bias_ih and bias_hh (G*H,)."""

    def __init__(self, c_in: int, hidden: int, mode: str,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.mode = mode
        G = MODES[mode] * hidden
        bound = 1.0 / math.sqrt(hidden)
        self.weight_ih = uniform((G, c_in), bound, generator)
        self.weight_hh = uniform((G, hidden), bound, generator)
        self.bias_ih = uniform((G,), bound, generator)
        self.bias_hh = uniform((G,), bound, generator)

    def forward(self, x: torch.Tensor, h0):
        dt = x.dtype
        w_hh = self.weight_hh.to(dt).contiguous()
        if self.mode == "LSTM":
            bias = self.bias_ih.to(dt) + self.bias_hh.to(dt)
            x_proj = F.linear(x, self.weight_ih.to(dt), bias)   # (B, T, 4H)
            ys, hT, cT = lstm(x_proj.contiguous(), w_hh,
                              h0[0].to(dt).contiguous(),
                              h0[1].to(dt).contiguous())
            return ys, (hT, cT)
        x_proj = F.linear(x, self.weight_ih.to(dt), self.bias_ih.to(dt))
        if self.mode == "GRU":
            return gru(x_proj.contiguous(), w_hh,
                       self.bias_hh.to(dt).contiguous(),
                       h0.to(dt).contiguous())
        return _rnn_scan(x_proj, w_hh, self.bias_hh.to(dt), h0.to(dt))


def _rnn_scan(x_proj: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
              h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """tanh RNN, h_t = tanh(x_proj[t] + h_{t-1} . W_hh^T + b_hh), with a
    float32 state like the kernels'; differentiable by torch autograd.
    x_proj (..., B, T, H), w_hh (..., H, H), b_hh (..., H), h0 (..., B, H):
    leading dims batch independent recurrences (the K prediction heads),
    each step one batched product."""
    w_t = w_hh.float().transpose(-1, -2)
    b = b_hh.float().unsqueeze(-2)
    xp = x_proj.float()
    h = h0.float()
    ys = []
    for t in range(x_proj.shape[-2]):
        h = torch.tanh(xp[..., t, :] + torch.matmul(h, w_t) + b)
        ys.append(h)
    return torch.stack(ys, dim=-2).to(x_proj.dtype), h.to(h0.dtype)


class CPCAR(nn.Module):
    """Multi-layer recurrent context network, ``mode`` GRU, LSTM or RNN."""

    def __init__(self, dim_input: int, dim_output: int, num_layers: int = 1,
                 mode: str = "LSTM",
                 generator: Optional[torch.Generator] = None,
                 reverse: bool = False):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"CPCAR mode must be one of {sorted(MODES)}, "
                             f"got {mode!r}")
        self.dim_output = dim_output
        self.num_layers = num_layers
        self.mode = mode
        self.reverse = reverse
        for layer in range(num_layers):
            c_in = dim_input if layer == 0 else dim_output
            setattr(self, f"layer{layer}",
                    _RecurrentLayer(c_in, dim_output, mode, generator))

    def zero_state(self, batch: int, dtype: torch.dtype,
                   device: torch.device) -> Hidden:
        shape = (self.num_layers, batch, self.dim_output)
        if self.mode == "LSTM":
            return (torch.zeros(shape, dtype=dtype, device=device),
                    torch.zeros(shape, dtype=dtype, device=device))
        return torch.zeros(shape, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, hidden: Optional[Hidden] = None,
                train: bool = False, seed: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Hidden]:
        """``train`` and ``seed`` are unused: a recurrent AR has no
        dropout."""
        if hidden is None:
            hidden = self.zero_state(x.shape[0], x.dtype, x.device)
        new_hidden = []
        y = x.flip(1) if self.reverse else x
        for layer in range(self.num_layers):
            h0 = (hidden[0][layer], hidden[1][layer]) \
                if self.mode == "LSTM" else hidden[layer]
            y, hT = getattr(self, f"layer{layer}")(y, h0)
            new_hidden.append(hT)
        if self.reverse:
            y = y.flip(1)
        if self.mode == "LSTM":
            return y, (torch.stack([h for h, _ in new_hidden]).detach(),
                       torch.stack([c for _, c in new_hidden]).detach())
        return y, torch.stack(new_hidden).detach()


class NoAr(nn.Module):
    """Identity AR (ar.py:175-182): the context is the encoding."""

    def zero_state(self, batch: int, dtype: torch.dtype,
                   device: torch.device) -> None:
        return None

    def forward(self, x: torch.Tensor, hidden=None, train: bool = False,
                seed: Optional[torch.Tensor] = None):
        return x, hidden


class BiDIRARTangled(nn.Module):
    """Bidirectional GRU with torch's ``nn.GRU(bidirectional=True)``
    semantics (ar.py:185-208): at every layer both directions read the
    concatenated two-direction output of the layer before (layers
    ``layer{l}_fwd`` / ``layer{l}_bwd``).  ``forward(x) -> (y, None)``
    from zero states."""

    def __init__(self, dim_input: int, dim_output: int, num_layers: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if dim_output % 2:
            raise ValueError(f"dim_output must be even, got {dim_output}")
        H = dim_output // 2
        self.num_layers = num_layers
        for layer in range(num_layers):
            c_in = dim_input if layer == 0 else dim_output
            for d in ("fwd", "bwd"):
                setattr(self, f"layer{layer}_{d}",
                        _RecurrentLayer(c_in, H, "GRU", generator))

    def forward(self, x: torch.Tensor, hidden=None, train: bool = False,
                seed: Optional[torch.Tensor] = None):
        y = x
        for layer in range(self.num_layers):
            fwd = getattr(self, f"layer{layer}_fwd")
            bwd = getattr(self, f"layer{layer}_bwd")
            h0 = y.new_zeros(y.shape[0], fwd.weight_hh.shape[1])
            yf, _ = fwd(y, h0)
            yb, _ = bwd(y.flip(1), h0)
            y = torch.cat([yf, yb.flip(1)], dim=2)
        return y, None


class BiDIRAR(nn.Module):
    """Bidirectional GRU as two independent multi-layer stacks (ar.py
    :211-226): ``netForward`` reads x, ``netBackward`` reads x flipped in
    time, and their outputs are concatenated at the end.
    ``forward(x) -> (y, None)`` from zero states."""

    def __init__(self, dim_input: int, dim_output: int, num_layers: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if dim_output % 2:
            raise ValueError(f"dim_output must be even, got {dim_output}")
        H = dim_output // 2
        self.netForward = CPCAR(dim_input, H, num_layers, "GRU", generator)
        self.netBackward = CPCAR(dim_input, H, num_layers, "GRU", generator)

    def forward(self, x: torch.Tensor, hidden=None, train: bool = False,
                seed: Optional[torch.Tensor] = None):
        yf, _ = self.netForward(x)
        yb, _ = self.netBackward(x.flip(1))
        return torch.cat([yf, yb.flip(1)], dim=2), None
