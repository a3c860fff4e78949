"""The conv encoder's norms (cpc_audio_tpu/models/norms.py): ChannelNorm
(``--normMode layerNorm``), InstanceNorm, Identity (``ID``) and flax's
BatchNorm, picked by :func:`make_norm_layer`.

The port keeps the encoder channels-first ``(B, C, T)``, PyTorch's conv
layout, so ChannelNorm normalises over dim 1, InstanceNorm over dim 2 and
BatchNorm over dims 0 and 2 (the JAX package is channels-last; the math
is the same).
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

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        # x: (B, C, T)
        xf = x.float()
        mean = xf.mean(dim=1, keepdim=True)
        var = xf.var(dim=1, keepdim=True, correction=1)
        y = ((xf - mean) * torch.rsqrt(var + self.epsilon)).to(x.dtype)
        return y * self.weight.to(x.dtype)[:, None] \
            + self.bias.to(x.dtype)[:, None]


class InstanceNorm(nn.Module):
    """InstanceNorm1d with affine and no running statistics (norms.py
    :55-77): each (batch, channel) normalised over time with the biased
    variance, float32 statistics, output and affine in the input dtype."""

    def __init__(self, num_features: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=2, keepdim=True)
        var = xf.var(dim=2, keepdim=True, correction=0)
        y = ((xf - mean) * torch.rsqrt(var + self.epsilon)).to(x.dtype)
        return y * self.weight.to(x.dtype)[:, None] \
            + self.bias.to(x.dtype)[:, None]


class Identity(nn.Module):
    """``--normMode ID`` (norms.py:80-85)."""

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return x


class BatchNorm(nn.Module):
    """flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` as the JAX
    encoder builds it (norms.py:96-100), not ``torch.nn.BatchNorm1d``:

    * in training the batch statistics over (B, T) are float32, the
      variance E[x^2] - E[x]^2 clipped at 0 (biased), and the running
      statistics (buffers ``mean``, ``var``, from 0 and 1) move by
      ``r = 0.9 r + 0.1 s`` in place; in eval they normalise;
    * the output takes the promoted dtype of the input and the float32
      parameters, as flax's module, built with no dtype, infers it: a
      bf16 input gives a float32 output.

    The parameters and statistics keep flax's names (``scale``, ``bias``;
    ``mean``, ``var`` of its ``batch_stats`` collection)."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5):
        super().__init__()
        self.momentum, self.epsilon = momentum, epsilon
        self.scale = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        xf = x.float()
        if train:
            mean = xf.mean(dim=(0, 2))
            var = torch.clamp_min((xf * xf).mean(dim=(0, 2)) - mean * mean,
                                  0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        return (xf - mean[:, None]) * mul[:, None] + self.bias[:, None]


NORM_MODES = {"layerNorm": ChannelNorm, "instanceNorm": InstanceNorm,
              "ID": lambda num_features: Identity(),
              "batchNorm": BatchNorm}


def make_norm_layer(norm_mode: str, num_features: int) -> nn.Module:
    """``--normMode`` -> the encoder's norm (norms.py:88-102)."""
    if norm_mode not in NORM_MODES:
        raise ValueError(f"Norm mode must be one of layerNorm/instanceNorm/"
                         f"ID/batchNorm, got {norm_mode}")
    return NORM_MODES[norm_mode](num_features)
