"""Validation step of the port (cpc_audio_tpu/parallel/train_step.py
:204-228), on one device.  ``make_train_step`` comes with the training
path (ROADMAP Queue 1 item 6)."""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch


def make_val_step(model: torch.nn.Module, criterion: torch.nn.Module,
                  device: torch.device) -> Callable:
    """``val_step(batch, hidden=None, generator=None, round_keys=None) ->
    (hidden, {"losses": (K,), "acc": (K,)})``.

    ``batch`` (B, 1, T) float waveforms, numpy or torch; ``generator``
    draws the negative sampler's round keys unless ``round_keys`` gives
    them.  Runs under ``torch.inference_mode`` and returns device
    tensors without synchronising."""
    device = torch.device(device)

    def val_step(batch, hidden=None,
                 generator: Optional[torch.Generator] = None,
                 round_keys: Optional[torch.Tensor] = None
                 ) -> Tuple[object, Dict[str, torch.Tensor]]:
        if isinstance(batch, np.ndarray):
            batch = torch.from_numpy(batch)
        batch = batch.to(device=device, dtype=torch.float32,
                         non_blocking=True)
        with torch.inference_mode():
            c, z, _, hid = model(batch, None, hidden)
            losses, acc = criterion(c, z, None, generator=generator,
                                    round_keys=round_keys)
        return hid, {"losses": losses, "acc": acc}

    return val_step
