"""CPCModel: encoder + autoregressive context network
(cpc_audio_tpu/models/cpc.py), for the default configuration.

``model(batch, label, hidden, train) -> (c, z, label, hidden_out)`` with
channels-last activations, as in the JAX package.  Parameters are float32;
activations run in ``config.compute_dtype``.  The default model has no
dropout, so ``train`` changes nothing here; gradients flow through cuDNN
convs and the K1 kernels.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from cpc_audio_tpu.config import CPCConfig

from .._common import compute_dtype
from .ar import CPCAR, Hidden
from .encoder import CPCEncoder

_NOT_PORTED = "ROADMAP Queue 1 item 11 (non-default variants)"


def _check_supported(config: CPCConfig) -> None:
    unsupported = {
        "encoder_type": (config.encoder_type, "cpc"),
        "normMode": (config.normMode, "layerNorm"),
        "arMode": (config.arMode, "LSTM"),
        "cpc_mode": (config.cpc_mode, None),
    }
    for field, (value, ported) in unsupported.items():
        if value != ported:
            raise NotImplementedError(
                f"{field}={value!r} is not ported yet: {_NOT_PORTED}")


class CPCModel(nn.Module):
    """Encoder + LSTM AR with an explicit hidden carry."""

    def __init__(self, config: CPCConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_supported(config)
        self.config = config
        self.dtype = compute_dtype(config.compute_dtype)
        self.gEncoder = CPCEncoder(config.hiddenEncoder, generator)
        self.gAR = CPCAR(config.hiddenEncoder, config.hiddenGar,
                         config.nLevelsGRU, generator)

    def forward(self, batch: torch.Tensor, label=None,
                hidden: Optional[Hidden] = None, train: bool = False):
        z = self.gEncoder(batch, self.dtype)             # (B, S, C)
        c, hidden_out = self.gAR(z, hidden)
        return c, z, label, hidden_out


def build_model(config: CPCConfig,
                generator: Optional[torch.Generator] = None) -> CPCModel:
    """Build a CPCModel with weights drawn from ``generator``."""
    return CPCModel(config, generator)
