"""Small helpers shared by the port's modules."""

from __future__ import annotations

from typing import Optional, Sequence

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
