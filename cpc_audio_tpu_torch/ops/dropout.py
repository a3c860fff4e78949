"""Counter-based dropout bits, keyed on absolute indices.

One generator, written twice and bit-identical: here in plain torch
(int64 tensors holding 32-bit words, masked after every step, as in
``feistel.py``) and in ``csrc/dropout.cuh`` for the kernels.  A bit word
is a function of (seed, site, w1, w2) only::

    bits = fmix(mix(w2, mix(w1, mix(seed, site))))

with ``mix`` the Feistel round function of ``feistel.py`` and ``fmix``
murmur3's finaliser.  The words are absolute indices, never a tile or
block id, so a backward pass regenerates the forward's mask whatever its
tiling, and the CPU and the card draw the same mask:

* attention probabilities: ``w1 = (k * n_batch + b) * nheads + h``,
  ``w2 = i * S + j``;
* FFN hidden: ``w1 = k * M + row``, ``w2 = f``;
* predictions (rate 0.5): ``w1 = (k * B + b) * W + w``, ``w2 = c``;
* the transformer AR's attention probabilities:
  ``w1 = layer * N + n`` with ``n = b * nheads + h``, ``w2 = i * S + j``;
* the transformer AR's FFN hidden: ``w1 = layer * B * S + row``,
  ``w2 = f``;
* the negative samplers' indices (not a dropout, the same hash):
  ``w1 = 0`` for the batch indices and ``1`` for the time offsets,
  ``w2`` = the flat index of the draw (:func:`negative_indices`).

An element is kept when ``bits >= rate * 2**32`` and scaled by
``1 / (1 - rate)``, as ``cpc_audio_tpu/ops/pallas/attention.py:52,66-67``.
The seed is an int64 tensor of shape (1,) on the data's device, read by
the kernels from device memory, so a train step needs no host sync to
change it.  The TPU's bits are not reproduced: against the JAX package,
compare at rate 0.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .feistel import _MASK32, _mix, _mul32

SITE_ATTENTION = 1
SITE_FFN = 2
SITE_PREDICTION = 3
SITE_STEP_SEED = 4      # train step: dropout seed from (key, step)
SITE_ROUND_KEYS = 5     # train step: Feistel round keys from (key, step)
SITE_AR_ATTENTION = 6   # transformer AR: attention probabilities
SITE_AR_FFN = 7         # transformer AR: FFN hidden
SITE_NEGATIVES = 8      # negative samplers: their seed from (key, step),
                        # then their indices from that seed


def _fmix(h: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 on 32-bit words."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def bits(seed: torch.Tensor, site: int, w1: torch.Tensor,
         w2: torch.Tensor) -> torch.Tensor:
    """32-bit words (int64) for index words ``w1``, ``w2`` (broadcast)."""
    h = _mix(seed.to(torch.int64) & _MASK32, site)
    h = _mix(w1.to(torch.int64) & _MASK32, h)
    h = _mix(w2.to(torch.int64) & _MASK32, h)
    return _fmix(h)


def threshold(rate: float) -> int:
    """Keep when bits >= threshold (the kernels take it as a uint32)."""
    return min(int(rate * 4294967296.0), 4294967295)


def check_rate(rate: float, seed, name: str) -> None:
    """Dropout needs 0 <= rate < 1, and a seed when rate > 0."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"{name}: dropout rate {rate} not in [0, 1)")
    if rate > 0.0:
        if seed is None:
            raise ValueError(f"{name}: dropout (rate {rate}) needs a seed")
        if seed.dtype != torch.int64 or tuple(seed.shape) != (1,):
            raise ValueError(f"{name}: seed must be an int64 tensor of "
                             f"shape (1,), got {seed.dtype} "
                             f"{tuple(seed.shape)}")


def kernel_args(rate: float, seed: Optional[torch.Tensor]) -> tuple:
    """(seed pointer, threshold, keep scale) as the kernels take them; a
    null seed pointer means no dropout."""
    if rate == 0.0:
        return (None, 0, 1.0)
    return (seed.data_ptr(), threshold(rate), 1.0 / (1.0 - rate))


def seed_tensors(rate: float, seed: Optional[torch.Tensor]) -> tuple:
    """The seed among a kernel's input tensors when it drops, else ()."""
    return (seed,) if rate > 0.0 else ()


def scale(keep: torch.Tensor, rate: float) -> torch.Tensor:
    """Float32 keep / (1 - rate)."""
    return keep.float() * (1.0 / (1.0 - rate))


def attention_mask(seed: torch.Tensor, rate: float, K: int, n_batch: int,
                   nheads: int, S: int, device) -> Optional[torch.Tensor]:
    """(K, n_batch, nheads, S, S) float32 keep / (1 - rate); None at rate
    0."""
    if rate == 0.0:
        return None
    w1 = torch.arange(K * n_batch * nheads, device=device).reshape(
        K, n_batch, nheads, 1, 1)
    w2 = torch.arange(S * S, device=device).reshape(S, S)
    return scale(bits(seed, SITE_ATTENTION, w1, w2) >= threshold(rate),
                 rate)


def ar_attention_mask(seed: torch.Tensor, rate: float, layer: int, N: int,
                      S: int, device) -> Optional[torch.Tensor]:
    """(N, S, S) float32 keep / (1 - rate) of the AR's attention layer
    ``layer`` over N = B * nheads rows; None at rate 0."""
    if rate == 0.0:
        return None
    w1 = (layer * N + torch.arange(N, device=device)).reshape(N, 1, 1)
    w2 = torch.arange(S * S, device=device).reshape(S, S)
    return scale(bits(seed, SITE_AR_ATTENTION, w1, w2) >= threshold(rate),
                 rate)


def ffn_mask(seed: torch.Tensor, rate: float, K: int, M: int, F: int,
             device) -> Optional[torch.Tensor]:
    """(K, M, F) float32 keep / (1 - rate); None at rate 0."""
    if rate == 0.0:
        return None
    w1 = torch.arange(K * M, device=device).reshape(K, M, 1)
    w2 = torch.arange(F, device=device)
    return scale(bits(seed, SITE_FFN, w1, w2) >= threshold(rate), rate)


def dropout(x: torch.Tensor, seed: torch.Tensor, rate: float,
            site: int = SITE_PREDICTION, offset: int = 0) -> torch.Tensor:
    """Dropout of a tensor whose last axis is the feature axis: w1 is
    ``offset`` plus the flat index of the leading axes, w2 the feature
    index."""
    check_rate(rate, seed, "dropout")
    if rate == 0.0:
        return x
    n = x.shape[-1]
    w1 = offset + torch.arange(x.numel() // n, device=x.device).reshape(
        x.shape[:-1] + (1,))
    w2 = torch.arange(n, device=x.device)
    mask = scale(bits(seed, site, w1, w2) >= threshold(rate), rate)
    return x * mask.to(x.dtype)


def step_words(key: torch.Tensor, site: int, step: torch.Tensor,
               n: int, first: int = 0) -> torch.Tensor:
    """(n,) int64 words ``first`` to ``first + n - 1`` from an epoch key and
    the step counter, both device tensors: the train step's dropout seed,
    round keys and negatives' seed (the role of
    ``cpc_audio_tpu/parallel/train_step.py`` stream_keys; ``first`` picks
    a rank's words)."""
    return bits(key, site, step.reshape(1),
                torch.arange(first, first + n, device=key.device))


def negative_indices(seed: torch.Tensor, shape, Bp: int, S: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The negative samplers' draws (``cpc_audio_tpu/criterion/
    infonce.py:116-117, 144-145``): int64 batch indices in [0, Bp) and time
    offsets in [1, S), each of ``shape``, from the bits of the (1,) int64
    ``seed`` at the negatives' site, on the seed's device.  A word maps to
    [0, n) as ``(bits * n) >> 32``.  JAX's threefry draws are not
    reproduced: against the JAX package, inject the indices."""
    n = 1
    for d in shape:
        n *= d
    w1 = torch.arange(2, device=seed.device).reshape(2, 1)
    h = bits(seed, SITE_NEGATIVES, w1, torch.arange(n, device=seed.device))
    batch = (h[0] * Bp) >> 32
    offset = 1 + ((h[1] * (S - 1)) >> 32)
    return batch.reshape(shape), offset.reshape(shape)
