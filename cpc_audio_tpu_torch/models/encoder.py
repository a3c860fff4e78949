"""CPCEncoder: five strided convs, each with ChannelNorm and ReLU, 160x
downsampling (cpc_audio_tpu/models/encoder.py:153-207).

The convs are plain ``F.conv1d`` (the JAX package leaves them to XLA on
its default path).  Activations run channels-first ``(B, C, T)``; the
output is the JAX package's channels-last ``(B, T // 160, C)``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .._common import uniform
from .norms import ChannelNorm

CONV_KERNELS = (10, 8, 4, 4, 4)
CONV_STRIDES = (5, 4, 2, 2, 2)
CONV_PADS = (3, 2, 1, 1, 1)


class _Conv(nn.Module):
    """Conv1d parameters in torch's (out, in, k) layout, torch init."""

    def __init__(self, c_in: int, c_out: int, k: int,
                 generator: Optional[torch.Generator]):
        super().__init__()
        bound = 1.0 / math.sqrt(c_in * k)
        self.weight = uniform((c_out, c_in, k), bound, generator)
        self.bias = uniform((c_out,), bound, generator)


class CPCEncoder(nn.Module):
    """Input (B, 1, T) or (B, T) waveform; output (B, T // 160, C)."""

    def __init__(self, size_hidden: int = 256,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.size_hidden = size_hidden
        c_in = 1
        for i, k in enumerate(CONV_KERNELS):
            setattr(self, f"conv{i}", _Conv(c_in, size_hidden, k, generator))
            setattr(self, f"norm{i}", ChannelNorm(size_hidden))
            c_in = size_hidden

    def forward(self, x: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        if x.dim() == 2:
            x = x[:, None, :]
        x = x.to(dtype)
        for i, (s, p) in enumerate(zip(CONV_STRIDES, CONV_PADS)):
            conv = getattr(self, f"conv{i}")
            x = F.conv1d(x, conv.weight.to(dtype), conv.bias.to(dtype),
                         stride=s, padding=p)
            x = torch.relu(getattr(self, f"norm{i}")(x))
        return x.transpose(1, 2).contiguous()
