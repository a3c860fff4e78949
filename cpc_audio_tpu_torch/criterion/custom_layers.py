"""Equalized-learning-rate layers, K-stacked for the prediction heads
(cpc_audio_tpu/criterion/custom_layers.py).

Weights start N(0, 1) and biases at 0; the He constant sqrt(2 / fan_in)
scales the whole output, bias included: ``y = (x . W + b) * c``.
Each layer holds the weights of K heads on a leading axis, as the JAX
package's vmapped heads do, and computes all K in one call.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def _normal(shape, generator: Optional[torch.Generator]) -> nn.Parameter:
    return nn.Parameter(torch.randn(tuple(shape), generator=generator))


class EqualizedDense(nn.Module):
    """K equalized linear layers (custom_layers.py:20-44): ``kernel (K,
    in, out)``, ``bias (K, out)``.  ``x`` is (M, in), read by every head
    (one product for all K), or (K, M, in) (a K-batched product); the
    output (K, M, out)."""

    def __init__(self, K: int, fan_in: int, features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel = _normal((K, fan_in, features), generator)
        self.bias = nn.Parameter(torch.zeros(K, features))
        self.scale = math.sqrt(2.0 / fan_in)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.kernel.to(x.dtype)
        y = torch.einsum("mc,kcd->kmd", x, w) if x.dim() == 2 \
            else torch.bmm(x, w)
        return (y + self.bias.to(x.dtype)[:, None]) * self.scale


class EqualizedConv1d(nn.Module):
    """K equalized convs of ``kernel_size`` taps, stride 1, no padding
    (custom_layers.py:47-79), each head's weight in torch's (out, in, W)
    layout: ``weight (K, out, in, W)``, ``bias (K, out)``.  All K heads
    read the same input, so they run as one cuDNN conv to K * out
    channels.  ``x`` (B, in, T) -> (K, B, out, T - W + 1)."""

    def __init__(self, K: int, in_features: int, features: int,
                 kernel_size: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = _normal((K, features, in_features, kernel_size),
                              generator)
        self.bias = nn.Parameter(torch.zeros(K, features))
        self.scale = math.sqrt(2.0 / (in_features * kernel_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        K, out, c_in, k = self.weight.shape
        y = F.conv1d(x, self.weight.to(x.dtype).reshape(K * out, c_in, k),
                     self.bias.to(x.dtype).reshape(-1))
        return y.reshape(x.shape[0], K, out, -1).transpose(0, 1) \
            * self.scale
