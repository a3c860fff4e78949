"""Hub-style model factory (cpc_audio_tpu/hub.py:26-64).

``cpc_audio(pretrained=True)`` loads the libri-light 60k checkpoint
(``60k_epoch4-d0f474de.pt``: ``{"config": ..., "weights": ...}``, the
weights a reference CPCModel state dict) from a local file, named by
``checkpoint_path=`` or the ``CPC_AUDIO_CHECKPOINT`` environment
variable; nothing is ever fetched.  The module comes back on the card
unless ``device`` says otherwise.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from . import convert
from ._common import resolve_device
from .config import CPCConfig
from .models import CPCModel, build_model

PRETRAINED_CHECKPOINT_NAME = "60k_epoch4-d0f474de.pt"


def cpc_audio(pretrained: bool = False,
              checkpoint_path: Optional[str] = None, device=None,
              **kwargs) -> CPCModel:
    """A CPC model in eval mode on ``device``: with ``pretrained``, the
    weights and config of the local checkpoint; else the default config
    updated by ``kwargs``, with seeded initial weights."""
    device = resolve_device(device)
    config = CPCConfig()
    if not pretrained:
        config = CPCConfig.from_dict({**config.to_dict(), **kwargs})
        return build_model(config, torch.Generator().manual_seed(0)) \
            .to(device).eval()
    path = checkpoint_path or os.environ.get("CPC_AUDIO_CHECKPOINT")
    if not path or not os.path.exists(path):
        raise FileNotFoundError(
            f"pretrained=True needs a local copy of "
            f"{PRETRAINED_CHECKPOINT_NAME}: pass checkpoint_path= or set "
            f"CPC_AUDIO_CHECKPOINT")
    checkpoint = torch.load(path, map_location="cpu", weights_only=True)
    config = CPCConfig.from_dict({**config.to_dict(),
                                  **checkpoint["config"]})
    model = build_model(config)
    model.load_state_dict(convert.convert_cpc_model(
        dict(checkpoint["weights"]), model.config))
    return model.to(device).eval()


# the reference's name
CPC_audio = cpc_audio
