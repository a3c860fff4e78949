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


def precision_policy() -> None:
    """The port's float32 precision policy, in one place: TF32 off for
    both float32 matrix products and cuDNN's convolutions, so that a
    ``--compute_dtype float32`` step on the card computes what the JAX
    package's float32 step computes on the CPU, the reference every port
    test is held against.  PyTorch's defaults leave
    ``torch.backends.cudnn.allow_tf32`` on, which runs float32
    convolutions in TF32 (about three decimal digits).  A bf16 step runs
    under the same flags.  Called by every entry point that runs a step
    or builds features (``train.main``, ``make_train_step``,
    ``make_val_step``, ``build_feature``); it sets process-wide flags and
    is idempotent."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``None`` means the first CUDA device, and raises where there is
    none: the port's entry points (the trainer, ``load_model``, the hub)
    run on the card unless the caller asks for another device."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port's entry points run on the GPU; pass "
            "device='cpu' (train.main(argv, device='cpu')) to run the "
            "plain versions on the CPU")
    return torch.device("cuda", 0)
