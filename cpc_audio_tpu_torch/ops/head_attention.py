"""Causal attention with Shaw relative positions: the K2 kernel and its
plain version.

Counterpart of ``cpc_audio_tpu/ops/pallas/head_attention.py``
``fused_relpos_attention`` (forward; dropout and the backward kernel come
with the training path).  q, k, v are ``(K, n_batch*S, D)`` with
``D = nheads*dk``, straight out of the K-batched projections; ``krel`` is
``(K, dk, S)``.  Per (k, batch row, head)::

    s[i, j] = (q_i . k_j + q_i . krel[:, j - i + S - 1]) / sqrt(dk),  j <= i
    o_i = softmax_j(s[i]) . v

``j - i + S - 1`` is the JAX kernel's skew ``(j - i - 1) mod S`` on the
causal region.  The JAX kernel pads S to a multiple of 128 for the TPU's
lane rotate; this one takes S as it is.
"""

from __future__ import annotations

import math

import torch

from . import _build

_NAME = "relpos_attention_fwd"


def _check_rate(rate: float) -> None:
    if rate != 0.0:
        raise NotImplementedError(
            "attention dropout (rate > 0): training path, ROADMAP Queue 1 "
            "item 6")


def relpos_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         krel: torch.Tensor, n_batch: int,
                         nheads: int) -> torch.Tensor:
    """Plain version: float32 scores and softmax; the probabilities are
    rounded to the input dtype before ``. v``, as in the JAX kernel."""
    K, M, D = q.shape
    S, dk = M // n_batch, D // nheads

    def heads(t):  # (K, M, D) -> (K, B, h, S, dk), float32
        return t.float().reshape(K, n_batch, S, nheads, dk).transpose(2, 3)

    qh, kh, vh = heads(q), heads(k), heads(v)
    qp = torch.einsum("kbhsd,kdr->kbhsr", qh, krel.float())
    i = torch.arange(S, device=q.device)[:, None]
    j = torch.arange(S, device=q.device)[None, :]
    skew = (j - i - 1) % S                      # == j - i + S - 1 for j <= i
    bias = torch.gather(qp, -1, skew.expand(K, n_batch, nheads, S, S))
    s = (qh @ kh.transpose(-1, -2) + bias) / math.sqrt(dk)
    s = s.masked_fill(j > i, float("-inf"))
    p = torch.softmax(s, dim=-1).to(q.dtype).float()
    o = p @ vh                                   # (K, B, h, S, dk)
    return o.transpose(2, 3).reshape(K, M, D).to(q.dtype)


def relpos_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     krel: torch.Tensor, n_batch: int, nheads: int,
                     rate: float = 0.0) -> torch.Tensor:
    """Returns (K, n_batch*S, D) in the input dtype.

    CPU tensors run :func:`relpos_attention_ref`; CUDA tensors launch the
    kernel (csrc/relpos_attention_fwd.cu) and add one to
    ``relpos_attention.launches``."""
    _check_rate(rate)
    if not _build.runs_kernel(_NAME, q, k, v, krel):
        return relpos_attention_ref(q, k, v, krel, n_batch, nheads)
    K, M, D = q.shape
    _build.require(n_batch > 0 and M % n_batch == 0 and D % nheads == 0,
                   _NAME, f"M={M}, D={D} vs n_batch={n_batch}, "
                   f"nheads={nheads}")
    S, dk = M // n_batch, D // nheads
    _build.check_inputs(_NAME, q.dtype, q=q, k=k, v=v, krel=krel)
    _build.require(tuple(k.shape) == tuple(q.shape)
                   and tuple(v.shape) == tuple(q.shape)
                   and tuple(krel.shape) == (K, dk, S), _NAME,
                   f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                   f"{tuple(v.shape)}, krel {tuple(krel.shape)}")
    _build.require(S > 0 and K > 0, _NAME, f"S={S}, K={K} out of range")
    out = torch.empty_like(q)
    lib = _build.library()
    with torch.cuda.device(q.device):
        status = lib.cpc_relpos_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), krel.data_ptr(),
            out.data_ptr(), K, n_batch, S, nheads, dk,
            _build.DTYPE_CODES[q.dtype], _build.stream(q.device))
    _build.check(status, _NAME)
    relpos_attention.launches += 1
    return out


relpos_attention.launches = 0
