"""Label-chain collapsing for the CTC criterion
(cpc_audio_tpu/criterion/seq_alignment.py:44-61).  The beam search and
the phone error rate come with the Common Voice evaluation."""

from __future__ import annotations

from typing import Tuple

import torch


def collapse_label_chain_padded(labels: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Remove consecutive repeats of each row of ``labels (B, T)`` on the
    device, at a static shape: returns (targets (B, T), paddings (B, T)
    float32), the collapsed labels left-packed, zeros after them, and
    paddings 1.0 past each row's collapsed length."""
    B, T = labels.shape
    keep = torch.ones_like(labels, dtype=torch.bool)
    keep[:, 1:] = labels[:, 1:] != labels[:, :-1]
    pos = torch.cumsum(keep, dim=1) - 1                 # destination slot
    pos = torch.where(keep, pos, torch.full_like(pos, T))   # dropped -> T
    targets = labels.new_zeros((B, T + 1))
    targets.scatter_(1, pos, labels)
    sizes = keep.sum(dim=1)
    paddings = (torch.arange(T, device=labels.device)[None, :]
                >= sizes[:, None]).float()
    return targets[:, :T], paddings
