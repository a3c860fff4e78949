"""CPCEncoder: five strided convs, each with ChannelNorm and ReLU, 160x
downsampling (cpc_audio_tpu/models/encoder.py:153-207).

By default the convs are plain ``F.conv1d`` (the JAX package leaves them to
XLA on its default path) with activations channels-first ``(B, C, T)``.
With ``fused_conv`` (``CPC_PALLAS_CONV=1`` through ``build_model``), each
layer that :func:`~cpc_audio_tpu_torch.ops.conv_ln.fused_conv_supported`
accepts runs conv + bias + ChannelNorm + ReLU as the K7 kernel
(``ops/conv_ln.py``) channels-last, as the JAX package's fused path does:
at the default config layers 1-4, not the waveform layer 0 (C_in = 1), which
is transposed once to ``(B, T, C)`` after it.  The parameters are the same
under both paths.  The output is the JAX package's channels-last
``(B, T // 160, C)``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .._common import uniform
from ..ops.conv_ln import conv_ln_relu, fused_conv_supported, out_frames
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
                 generator: Optional[torch.Generator] = None,
                 fused_conv: bool = False):
        super().__init__()
        self.size_hidden = size_hidden
        self.fused_conv = fused_conv
        c_in = 1
        for i, k in enumerate(CONV_KERNELS):
            setattr(self, f"conv{i}", _Conv(c_in, size_hidden, k, generator))
            setattr(self, f"norm{i}", ChannelNorm(size_hidden))
            c_in = size_hidden

    def fused_layers(self, n_samples: int) -> Tuple[int, ...]:
        """The layers that run as the K7 kernel for an n_samples input."""
        if not self.fused_conv:
            return ()
        fused, T = [], n_samples
        for i, (k, s, p) in enumerate(zip(CONV_KERNELS, CONV_STRIDES,
                                          CONV_PADS)):
            c_out, c_in, _ = getattr(self, f"conv{i}").weight.shape
            if fused_conv_supported(c_in, c_out, k, s, p, T):
                fused.append(i)
            T = out_frames(T, k, s, p)
        return tuple(fused)

    def forward(self, x: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        if x.dim() == 2:
            x = x[:, None, :]
        x = x.to(dtype)
        fused = self.fused_layers(x.shape[-1])
        last = False                      # layout: channels-last or -first
        for i, (k, s, p) in enumerate(zip(CONV_KERNELS, CONV_STRIDES,
                                          CONV_PADS)):
            conv, norm = getattr(self, f"conv{i}"), getattr(self, f"norm{i}")
            if i in fused:
                if not last:
                    x, last = x.transpose(1, 2).contiguous(), True
                c_out, c_in, _ = conv.weight.shape
                w = conv.weight.to(dtype).permute(2, 1, 0).reshape(
                    k * c_in, c_out).contiguous()
                x = conv_ln_relu(x, w, conv.bias, norm.weight, norm.bias, s,
                                 k, p, norm.epsilon)
                continue
            if last:
                x, last = x.transpose(1, 2), False
            x = F.conv1d(x, conv.weight.to(dtype), conv.bias.to(dtype),
                         stride=s, padding=p)
            x = torch.relu(norm(x))
        return x if last else x.transpose(1, 2).contiguous()
