"""Small helpers shared by the port's modules."""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(name: str) -> torch.dtype:
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of "
                         f"{sorted(COMPUTE_DTYPES)}, got {name!r}")
    return COMPUTE_DTYPES[name]


def uniform(shape: Sequence[int], bound: float,
            generator: Optional[torch.Generator]) -> torch.nn.Parameter:
    """U(-bound, bound) parameter (the JAX package's torch-style inits)."""
    t = torch.rand(tuple(shape), generator=generator) * (2 * bound) - bound
    return torch.nn.Parameter(t)


def fused_layer_switches() -> Tuple[bool, bool]:
    """(fused_conv, attention_block): the JAX package's opt-in fused-layer
    path, read from the same two variables, so one command line picks the
    same path in both packages: ``CPC_PALLAS_CONV=1`` fuses the encoder's
    conv + ChannelNorm + ReLU layers (K7), ``CPC_ATTN_BLOCK=1`` runs the
    heads' whole attention block in one kernel (K6)."""
    return (os.environ.get("CPC_PALLAS_CONV", "0") == "1",
            os.environ.get("CPC_ATTN_BLOCK", "0") == "1")
