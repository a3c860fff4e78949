"""Causal attention with Shaw relative positions: the K2 kernels and their
plain versions.

Counterpart of ``cpc_audio_tpu/ops/pallas/head_attention.py``
``fused_relpos_attention`` and its custom VJP.  q, k, v are
``(K, n_batch*S, D)`` with ``D = nheads*dk``, straight out of the
K-batched projections; ``krel`` is ``(K, dk, S)``.  Per (k, batch row,
head)::

    s[i, j] = (q_i . k_j + q_i . krel[:, j - i + S - 1]) / sqrt(dk),  j <= i
    o_i = (softmax_j(s[i]) * dropout[i]) . v

``j - i + S - 1`` is the JAX kernel's skew ``(j - i - 1) mod S`` on the
causal region.  The JAX kernel pads S to a multiple of 128 for the TPU's
lane rotate; these take S as it is.  Dropout (training) drops the
probabilities with the counter-based bits of ``ops/dropout.py``, keyed on
(k, batch row, head, i, j).

:func:`relpos_attention` is the differentiable entry point: its forward
runs the K2 forward kernel (csrc/relpos_attention_fwd.cu, counted in
``relpos_attention.launches``), its backward the K2 backward kernel
(csrc/relpos_attention_bwd.cu, counted in
``relpos_attention_bwd.launches``).  CPU tensors take the plain versions.

Each block stages its head's operands in shared memory: as float32 at
the default shapes, in bf16 where float32 does not fit (bf16 inputs), and
past that the kernels read them in place; each kernel picks its layout
from (S, dk) at compile time, and :func:`supported` gives the (S, dk)
they take, without a card.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from . import _build, dropout

_NAME = "relpos_attention_fwd"
_BWD_NAME = "relpos_attention_bwd"
# the longest sequence the kernels are checked at on the card (S 1012 and
# 1024 in tests/test_torch_cuda.py; --sizeWindow 163840 gives 1012
# anchors).  Their memory would take more: past shared memory a block
# keeps its (S, S) ds and p r rows in 8 warps' float32 rows of S each, two
# per warp, 64 S bytes within 227 KB (S 3632)
MAX_S = 1024
# bytes of the backward's device-memory (S, S) tiles that one call holds
# at once: past it the launches walk the (k, b) rows of heads in chunks,
# each reusing the scratch (a (k, b, h) block takes 2 S^2 values: 8.4 MB
# in float32 at S 1024, 67 MB a row of 8 heads, 25 GB over 12 heads at
# B 32)
TILE_BUDGET = 1 << 30


def supported(S: int, dk: int) -> Optional[str]:
    """Why the kernels refuse a sequence length S and head width dk, or
    None: S <= 1024, the longest checked on the card (a block's 8 warps
    keep two float32 rows of S beside any operands in shared memory; the
    (S, S) tiles go to a device-memory scratch of at most
    ``TILE_BUDGET``, walked in chunks of blocks) and any dk, in both
    dtypes (the
    kernels read a head's columns one at a time, so any dk is aligned;
    past their shared memory the operands are read in place, whose shared
    memory, the score rows, does not grow with dk)."""
    if not (0 < S <= MAX_S and dk > 0):
        return f"S={S}, dk={dk} out of range (0 < S <= {MAX_S}, dk > 0)"
    return None


def _heads(t: torch.Tensor, n_batch: int, nheads: int) -> torch.Tensor:
    """(K, M, D) -> (K, B, h, S, dk), float32."""
    K, M, D = t.shape
    return t.float().reshape(K, n_batch, M // n_batch, nheads,
                             D // nheads).transpose(2, 3)


def _unheads(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    K, B, h, S, dk = t.shape
    return t.transpose(2, 3).reshape(K, B * S, h * dk).to(dtype)


def _skew(S: int, device) -> torch.Tensor:
    """(S, S) rel-pos column (j - i - 1) mod S == j - i + S - 1 on j <= i."""
    i = torch.arange(S, device=device)[:, None]
    j = torch.arange(S, device=device)[None, :]
    return (j - i - 1) % S


def _probs(qh, kh, krel, S: int) -> torch.Tensor:
    """Causal softmax probabilities (K, B, h, S, S), float32."""
    K, B, h, _, dk = qh.shape
    qp = torch.einsum("kbhsd,kdr->kbhsr", qh, krel.float())
    bias = torch.gather(qp, -1, _skew(S, qh.device).expand(K, B, h, S, S))
    s = (qh @ kh.transpose(-1, -2) + bias) / math.sqrt(dk)
    causal = torch.ones(S, S, dtype=torch.bool, device=qh.device).tril()
    return torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)


def relpos_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         krel: torch.Tensor, n_batch: int, nheads: int,
                         rate: float = 0.0,
                         seed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: float32 scores and softmax; the dropped
    probabilities are rounded to the input dtype before ``. v``, as in the
    JAX kernel.  Differentiable by torch autograd."""
    K, M, _ = q.shape
    S = M // n_batch
    qh, kh, vh = (_heads(t, n_batch, nheads) for t in (q, k, v))
    p = _probs(qh, kh, krel, S)
    mask = dropout.attention_mask(seed, rate, K, n_batch, nheads, S,
                                  q.device)
    if mask is not None:
        p = p * mask
    return _unheads(p.to(q.dtype).float() @ vh, q.dtype)


def relpos_attention_bwd_ref(q, k, v, krel, dout, n_batch: int, nheads: int,
                             rate: float = 0.0,
                             seed: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, ...]:
    """Plain backward, the math of ``_bwd_kernel`` (head_attention.py
    :158-228): (dq, dk, dv) in the input dtype and dkrel (K, dk, S)
    float32, summed over batch rows and heads."""
    K, M, D = q.shape
    S, dk = M // n_batch, D // nheads
    dt = q.dtype
    qh, kh, vh, doh = (_heads(t, n_batch, nheads) for t in (q, k, v, dout))
    p = _probs(qh, kh, krel, S)
    mask = dropout.attention_mask(seed, rate, K, n_batch, nheads, S,
                                  q.device)
    pd = p if mask is None else p * mask
    dvh = pd.to(dt).float().transpose(-1, -2) @ doh
    dp = doh @ vh.transpose(-1, -2)
    if mask is not None:
        dp = dp * mask
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) / math.sqrt(dk)
    ds = ds.to(dt).float()
    skew = _skew(S, q.device)
    krel_sk = krel.float()[:, :, skew]                       # (K, dk, S, S)
    dqh = ds @ kh + torch.einsum("kbhij,kdij->kbhid", ds, krel_sk)
    dkh = ds.transpose(-1, -2) @ qh
    per_pair = torch.einsum("kbhid,kbhij->kdij", qh, ds)     # (K, dk, S, S)
    dkrel = torch.zeros((K, dk, S), dtype=torch.float32, device=q.device)
    dkrel.index_add_(2, skew.reshape(-1), per_pair.reshape(K, dk, S * S))
    return (_unheads(dqh, dt), _unheads(dkh, dt), _unheads(dvh, dt), dkrel)


def _check_shapes(name: str, q, k, v, krel, n_batch: int, nheads: int,
                  others=()) -> Tuple[int, int]:
    K, M, D = q.shape
    _build.require(n_batch > 0 and M % n_batch == 0 and D % nheads == 0,
                   name, f"M={M}, D={D} vs n_batch={n_batch}, "
                   f"nheads={nheads}")
    S, dk = M // n_batch, D // nheads
    _build.require(all(tuple(t.shape) == tuple(q.shape) for t in (k, v)
                       + tuple(others))
                   and tuple(krel.shape) == (K, dk, S), name,
                   f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                   f"{tuple(v.shape)}, krel {tuple(krel.shape)}")
    _build.require(K > 0, name, f"K={K} out of range")
    why = supported(S, dk)
    _build.require(why is None, name, why or "")
    return S, dk


def relpos_attention_fwd(q, k, v, krel, n_batch: int, nheads: int,
                         rate: float = 0.0,
                         seed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Forward: (K, n_batch*S, D) in the input dtype.  CPU tensors run
    :func:`relpos_attention_ref`; CUDA tensors launch the kernel and add
    one to ``relpos_attention.launches``."""
    dropout.check_rate(rate, seed, _NAME)
    if not _build.runs_kernel(_NAME, q, k, v, krel,
                              *dropout.seed_tensors(rate, seed)):
        return relpos_attention_ref(q, k, v, krel, n_batch, nheads, rate,
                                    seed)
    K = q.shape[0]
    S, dk = _check_shapes(_NAME, q, k, v, krel, n_batch, nheads)
    _build.check_inputs(_NAME, q.dtype, q=q, k=k, v=v, krel=krel)
    out = torch.empty_like(q)
    lib = _build.library()
    with torch.cuda.device(q.device):
        status = lib.cpc_relpos_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), krel.data_ptr(),
            out.data_ptr(), K, n_batch, S, nheads, dk,
            *dropout.kernel_args(rate, seed), _build.DTYPE_CODES[q.dtype],
            _build.stream(q.device))
    _build.check(status, _NAME)
    relpos_attention.launches += 1
    return out


def tile_chunk(per_row: int, K: int, n_batch: int) -> Tuple[int, int]:
    """(k_chunk, b_chunk): the heads k and batch rows b a backward launch
    takes when one (k, b) row of attention heads needs ``per_row`` bytes
    of device-memory tiles: all where they fit ``TILE_BUDGET`` (or need
    none), else as many whole k as fit, else one k and as many rows b as
    fit, at least one (a row of 8 heads at S <= ``MAX_S`` takes 67 MB at
    most)."""
    rows = K * n_batch if per_row == 0 else max(1, TILE_BUDGET // per_row)
    if rows >= n_batch:
        return min(K, rows // n_batch), n_batch
    return 1, rows


def relpos_attention_bwd(q, k, v, krel, dout, n_batch: int, nheads: int,
                         rate: float = 0.0,
                         seed: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, ...]:
    """Backward: (dq, dk, dv) in the input dtype, dkrel float32.  CPU
    tensors run :func:`relpos_attention_bwd_ref`; CUDA tensors launch the
    kernel and add one to ``relpos_attention_bwd.launches``."""
    dropout.check_rate(rate, seed, _BWD_NAME)
    if not _build.runs_kernel(_BWD_NAME, q, k, v, krel, dout,
                              *dropout.seed_tensors(rate, seed)):
        return relpos_attention_bwd_ref(q, k, v, krel, dout, n_batch,
                                        nheads, rate, seed)
    K = q.shape[0]
    S, dk = _check_shapes(_BWD_NAME, q, k, v, krel, n_batch, nheads,
                          (dout,))
    _build.check_inputs(_BWD_NAME, q.dtype, q=q, k=k, v=v, krel=krel,
                        dout=dout)
    lib = _build.library()
    code = _build.DTYPE_CODES[q.dtype]
    dq, dkk, dv = (torch.empty_like(q) for _ in range(3))
    dkrel = torch.empty((K, dk, S), dtype=torch.float32, device=q.device)
    part = torch.empty((K, n_batch * nheads, dk, S), dtype=torch.float32,
                       device=q.device)
    # the (S, S) ds and p * r tiles of each block, where they do not fit
    # in shared memory beside the operands: one chunk of blocks at a time
    k_chunk, b_chunk = tile_chunk(lib.cpc_relpos_attention_bwd_scratch(
        nheads, S, dk, code), K, n_batch)
    n_tiles = lib.cpc_relpos_attention_bwd_scratch(
        k_chunk * b_chunk * nheads, S, dk, code)
    tiles = torch.empty(n_tiles, dtype=torch.uint8,
                        device=q.device) if n_tiles else None
    with torch.cuda.device(q.device):
        status = lib.cpc_relpos_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), krel.data_ptr(),
            dout.data_ptr(), dq.data_ptr(), dkk.data_ptr(), dv.data_ptr(),
            dkrel.data_ptr(), part.data_ptr(), _build.ptr(tiles), K,
            k_chunk, b_chunk, n_batch, S, nheads, dk,
            *dropout.kernel_args(rate, seed), code, _build.stream(q.device))
    _build.check(status, _BWD_NAME)
    relpos_attention_bwd.launches += 1
    return dq, dkk, dv, dkrel


relpos_attention_bwd.launches = 0


class _RelposAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, krel, seed, n_batch, nheads, rate):
        ctx.save_for_backward(q, k, v, krel, seed)
        ctx.args = (n_batch, nheads, rate)
        return relpos_attention_fwd(q, k, v, krel, n_batch, nheads, rate,
                                    seed)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, krel, seed = ctx.saved_tensors
        n_batch, nheads, rate = ctx.args
        dq, dk, dv, dkrel = relpos_attention_bwd(
            q, k, v, krel, dout.to(q.dtype).contiguous(), n_batch, nheads,
            rate, seed)
        return dq, dk, dv, dkrel.to(krel.dtype), None, None, None, None


def relpos_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     krel: torch.Tensor, n_batch: int, nheads: int,
                     rate: float = 0.0,
                     seed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Differentiable attention, (K, n_batch*S, D) in the input dtype.

    ``rate > 0`` drops probabilities (training) with ``seed``, an int64
    tensor of shape (1,) on the inputs' device."""
    dropout.check_rate(rate, seed, _NAME)
    return _RelposAttention.apply(q, k, v, krel, seed, n_batch, nheads,
                                  rate)


relpos_attention.launches = 0
