"""ChannelNorm for the conv encoder (cpc_audio_tpu/models/norms.py:16-53).

The port keeps the encoder channels-first ``(B, C, T)``, PyTorch's conv
layout, so ChannelNorm normalises over dim 1 (the JAX package is
channels-last and normalises the last axis; the math is the same).
"""

from __future__ import annotations

import torch
from torch import nn


class ChannelNorm(nn.Module):
    """Per-timestep normalisation across channels: unbiased variance
    (ddof=1), eps added to the variance, float32 statistics, output and
    affine in the input dtype."""

    def __init__(self, num_features: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: (B, C, T)
        xf = x.float()
        mean = xf.mean(dim=1, keepdim=True)
        var = xf.var(dim=1, keepdim=True, correction=1)
        y = ((xf - mean) * torch.rsqrt(var + self.epsilon)).to(x.dtype)
        return y * self.weight.to(x.dtype)[:, None] \
            + self.bias.to(x.dtype)[:, None]
