"""Keyed permutations of [0, 2**nbits) (Feistel network) in int64.

Bit-for-bit the permutation of ``cpc_audio_tpu/ops/feistel.py``: an
alternating unbalanced Feistel over the high/low bit halves with a
murmur-style round function, used by the stratified negative sampler.
torch has few uint32 operations, so values are int64 holding 32-bit words
and every step masks with ``& 0xFFFFFFFF``.  A 32-bit product is formed
from two 16-bit halves of the constant so that no intermediate exceeds
2**49 (int64 overflow would be undefined behaviour in the kernels).
"""

from __future__ import annotations

import torch

ROUNDS = 5

_MASK32 = 0xFFFFFFFF
_M1 = 0x9E3779B1
_M2 = 0x85EBCA6B


def _mul32(a: torch.Tensor, m: int) -> torch.Tensor:
    """(a * m) mod 2**32 for 32-bit words a and constant m."""
    lo = a * (m & 0xFFFF)
    hi = ((a * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _mix(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Murmur3-style avalanche of a 32-bit word under key k."""
    h = _mul32(x ^ k, _M1)
    h = h ^ (h >> 15)
    h = _mul32(h, _M2)
    return h ^ (h >> 13)


def _split(nbits: int):
    lb = nbits // 2
    hb = nbits - lb
    return lb, (1 << hb) - 1, (1 << lb) - 1


def feistel_permute(x: torch.Tensor, keys: torch.Tensor,
                    nbits: int) -> torch.Tensor:
    """Apply the keyed permutation elementwise to ``x`` in [0, 2**nbits).

    keys: (ROUNDS,) integers in [0, 2**32).  Returns int64."""
    lb, mask_l, mask_r = _split(nbits)
    x = x.to(torch.int64)
    keys = keys.to(device=x.device, dtype=torch.int64)
    left = (x >> lb) & mask_l
    right = x & mask_r
    for i in range(keys.shape[-1]):
        if i % 2 == 0:
            left = (left + _mix(right, keys[i])) & mask_l
        else:
            right = (right + _mix(left, keys[i])) & mask_r
    return (left << lb) | right


def feistel_inverse(y: torch.Tensor, keys: torch.Tensor,
                    nbits: int) -> torch.Tensor:
    """Inverse of :func:`feistel_permute` (same keys)."""
    lb, mask_l, mask_r = _split(nbits)
    y = y.to(torch.int64)
    keys = keys.to(device=y.device, dtype=torch.int64)
    left = (y >> lb) & mask_l
    right = y & mask_r
    for i in reversed(range(keys.shape[-1])):
        if i % 2 == 0:
            left = (left - _mix(right, keys[i])) & mask_l
        else:
            right = (right - _mix(left, keys[i])) & mask_r
    return (left << lb) | right
