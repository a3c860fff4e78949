"""The prediction heads' whole attention block: the K6 kernels and their
plain versions.

Counterpart of ``cpc_audio_tpu/ops/pallas/head_attention.py``
``fused_attention_block`` and its custom VJP, the path the JAX package
takes under ``CPC_ATTN_BLOCK=1``.  For the context ``c (M, D)``, ``M =
n_batch*S``, ``D = nheads*dk``, weights ``wq/wk/wv/wo (K, D, D)`` and
``krel (K, dk, S)``::

    q, k, v = round(c . Wq[k]), round(c . Wk[k]), round(c . Wv[k])
    x[k]    = round(c + round(attention(q, k, v, krel) . Wo[k]))

with ``round()`` the rounding to c's dtype after float32 accumulation
(the JAX kernel's ``_dot_cast``) and ``attention`` the causal Shaw
attention of ``ops/head_attention.py``, whose per-head outputs are rounded
too.  Dropout drops its probabilities with ``dropout.attention_mask``
(site ``SITE_ATTENTION``, keyed on (k, batch row, head, i, j)): at one seed
the block and the unfused K2 path drop the same probabilities.

:func:`attention_block` is the differentiable entry point: its forward
runs the K6 forward kernel (csrc/attention_block_fwd.cu, counted in
``attention_block.launches``), its backward the K6 backward kernels
(csrc/attention_block_bwd.cu, counted in ``attention_block_bwd.launches``),
which return ``dc = sum_k (dcp[k] + dout[k])`` with the sum taken here, as
the JAX package takes it outside its kernel.  CPU tensors take the plain
versions.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build, dropout
from .head_attention import relpos_attention_bwd_ref, relpos_attention_ref

_NAME = "attention_block_fwd"
_BWD_NAME = "attention_block_bwd"


def attention_block_supported(S: int, nheads: int, dk: int) -> bool:
    """The kernels' own conditions: dk a multiple of 16 (tensor-core
    tiles), D a multiple of 64 (the projections' chunks) and at most 256,
    the (S, D) output accumulator of a block within its registers (S
    rounded up to 16, times D, at most 32768) and the backward's two
    (S, S) float32 tiles with the five (S, dk + 1) operand tiles within
    the 227 KB of shared memory a block may use."""
    D = nheads * dk
    smem = 4 * (2 * S * S + 5 * S * (dk + 1)) + 16384
    return (S > 0 and dk % 16 == 0 and D % 64 == 0 and D <= 256
            and -(-S // 16) * 16 * D <= 32768 and smem <= _build.SMEM_LIMIT)


def supported(S: int, nheads: int, dk: int) -> Optional[str]:
    """Why the kernels refuse (S, nheads, dk), or None
    (:func:`attention_block_supported` with its reason)."""
    if attention_block_supported(S, nheads, dk):
        return None
    return (f"S={S}, nheads={nheads}, dk={dk} outside the kernel's shapes "
            f"(attention_block_supported: dk % 16 == 0, D = nheads * dk a "
            f"multiple of 64 up to 256, the (S, S) float32 tiles within "
            f"227 KB)")


def _project(c: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, D) . (K, D, D) -> (K, M, D), float32 sums rounded to c's dtype."""
    return (c.float() @ w.float()).to(c.dtype)


def attention_block_ref(c, wq, wk, wv, wo, krel, n_batch: int, nheads: int,
                        rate: float = 0.0,
                        seed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version, (K, M, D) in c's dtype.  Differentiable by torch
    autograd."""
    dt = c.dtype
    q, k, v = (_project(c, w) for w in (wq, wk, wv))
    y = relpos_attention_ref(q, k, v, krel, n_batch, nheads, rate, seed)
    att = (y.float() @ wo.float()).to(dt)
    return (c.float() + att.float()).to(dt)


def _dc(dcp: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """dc = sum_k (dcp[k] + dout[k]), the JAX package's epilogue."""
    return (dcp + dout).float().sum(0).to(dcp.dtype)


def attention_block_bwd_ref(c, wq, wk, wv, wo, krel, dout, n_batch: int,
                            nheads: int, rate: float = 0.0,
                            seed: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, ...]:
    """Plain backward, the math of ``_block_bwd_kernel``
    (head_attention.py:421-512) and its epilogue: dc in c's dtype and
    float32 (dWq, dWk, dWv, dWo, dkrel), each summed over the rows."""
    dt = c.dtype
    q, k, v = (_project(c, w) for w in (wq, wk, wv))
    dy = (dout.float() @ wo.float().transpose(1, 2)).to(dt)
    dq, dk, dv, dkrel = relpos_attention_bwd_ref(q, k, v, krel, dy, n_batch,
                                                 nheads, rate, seed)
    y = relpos_attention_ref(q, k, v, krel, n_batch, nheads, rate, seed)
    ct = c.float().t()
    dwq, dwk, dwv = (ct @ g.float() for g in (dq, dk, dv))
    dwo = y.float().transpose(1, 2) @ dout.float()
    dcp = sum(g.float() @ w.float().transpose(1, 2)
              for g, w in ((dq, wq), (dk, wk), (dv, wv))).to(dt)
    return _dc(dcp, dout), dwq, dwk, dwv, dwo, dkrel


def _check(name: str, c, wq, wk, wv, wo, krel, n_batch: int, nheads: int,
           others=()) -> Tuple[int, int, int]:
    M, D = c.shape
    K = wq.shape[0]
    _build.require(n_batch > 0 and M % n_batch == 0 and D % nheads == 0,
                   name, f"M={M}, D={D} vs n_batch={n_batch}, "
                   f"nheads={nheads}")
    S, dk = M // n_batch, D // nheads
    _build.require(all(tuple(w.shape) == (K, D, D) for w in (wq, wk, wv, wo))
                   and tuple(krel.shape) == (K, dk, S)
                   and all(tuple(t.shape) == (K, M, D) for t in others),
                   name, f"shapes c {tuple(c.shape)}, wq {tuple(wq.shape)}, "
                   f"krel {tuple(krel.shape)}")
    why = supported(S, nheads, dk)
    _build.require(why is None, name, why or "")
    return K, S, dk


def attention_block_fwd(c, wq, wk, wv, wo, krel, n_batch: int, nheads: int,
                        rate: float = 0.0,
                        seed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Forward: (K, M, D) in c's dtype.  CPU tensors run
    :func:`attention_block_ref`; CUDA tensors launch the kernel and add one
    to ``attention_block.launches``."""
    dropout.check_rate(rate, seed, _NAME)
    if not _build.runs_kernel(_NAME, c, wq, wk, wv, wo, krel,
                              *dropout.seed_tensors(rate, seed)):
        return attention_block_ref(c, wq, wk, wv, wo, krel, n_batch, nheads,
                                   rate, seed)
    K, S, dk = _check(_NAME, c, wq, wk, wv, wo, krel, n_batch, nheads)
    _build.check_inputs(_NAME, c.dtype, c=c, wq=wq, wk=wk, wv=wv, wo=wo,
                        krel=krel)
    _build.require_aligned(_NAME, c=c, wq=wq, wk=wk, wv=wv, wo=wo)
    lib = _build.library()
    code = _build.DTYPE_CODES[c.dtype]
    _build.require_smem(_NAME, lib.cpc_attention_block_fwd_smem(
        S, nheads, dk, code), f"S={S}, dk={dk}")
    M, D = c.shape
    x = torch.empty((K, M, D), dtype=c.dtype, device=c.device)
    with torch.cuda.device(c.device):
        status = lib.cpc_attention_block_fwd(
            c.data_ptr(), wq.data_ptr(), wk.data_ptr(), wv.data_ptr(),
            wo.data_ptr(), krel.data_ptr(), x.data_ptr(), K, n_batch, S,
            nheads, dk, *dropout.kernel_args(rate, seed), code,
            _build.stream(c.device))
    _build.check(status, _NAME)
    attention_block.launches += 1
    return x


def attention_block_bwd(c, wq, wk, wv, wo, krel, dout, n_batch: int,
                        nheads: int, rate: float = 0.0,
                        seed: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, ...]:
    """Backward: dc in c's dtype and float32 (dWq, dWk, dWv, dWo, dkrel).
    CPU tensors run :func:`attention_block_bwd_ref`; CUDA tensors launch
    the kernels and add one to ``attention_block_bwd.launches``."""
    dropout.check_rate(rate, seed, _BWD_NAME)
    if not _build.runs_kernel(_BWD_NAME, c, wq, wk, wv, wo, krel, dout,
                              *dropout.seed_tensors(rate, seed)):
        return attention_block_bwd_ref(c, wq, wk, wv, wo, krel, dout,
                                       n_batch, nheads, rate, seed)
    K, S, dk = _check(_BWD_NAME, c, wq, wk, wv, wo, krel, n_batch, nheads,
                      (dout,))
    _build.check_inputs(_BWD_NAME, c.dtype, c=c, wq=wq, wk=wk, wv=wv, wo=wo,
                        krel=krel, dout=dout)
    _build.require_aligned(_BWD_NAME, c=c, wq=wq, wk=wk, wv=wv, wo=wo,
                           dout=dout)
    lib = _build.library()
    code = _build.DTYPE_CODES[c.dtype]
    _build.require_smem(_BWD_NAME, lib.cpc_attention_block_bwd_smem(
        S, nheads, dk, code), f"S={S}, dk={dk}")
    M, D = c.shape
    dev = c.device
    f32 = dict(dtype=torch.float32, device=dev)
    dq, dk_, dv, y, dcp = (torch.empty_like(dout) for _ in range(5))
    part = torch.empty((K, n_batch * nheads, dk, S), **f32)
    dkrel = torch.empty((K, dk, S), **f32)
    dw = torch.empty((4, K, D, D), **f32)
    with torch.cuda.device(dev):
        status = lib.cpc_attention_block_bwd(
            c.data_ptr(), wq.data_ptr(), wk.data_ptr(), wv.data_ptr(),
            wo.data_ptr(), krel.data_ptr(), dout.data_ptr(), dq.data_ptr(),
            dk_.data_ptr(), dv.data_ptr(), y.data_ptr(), part.data_ptr(),
            dkrel.data_ptr(), dw.data_ptr(), dcp.data_ptr(), K, n_batch, S,
            nheads, dk, *dropout.kernel_args(rate, seed), code,
            _build.stream(dev))
    _build.check(status, _BWD_NAME)
    attention_block_bwd.launches += 1
    dwq, dwk, dwv, dwo = dw
    return _dc(dcp, dout), dwq, dwk, dwv, dwo, dkrel


attention_block_bwd.launches = 0


class _AttentionBlock(torch.autograd.Function):

    @staticmethod
    def forward(ctx, c, wq, wk, wv, wo, krel, seed, n_batch, nheads, rate):
        ctx.save_for_backward(c, wq, wk, wv, wo, krel, seed)
        ctx.args = (n_batch, nheads, rate)
        return attention_block_fwd(c, wq, wk, wv, wo, krel, n_batch, nheads,
                                   rate, seed)

    @staticmethod
    def backward(ctx, dout):
        *ins, seed = ctx.saved_tensors
        grads = attention_block_bwd(*ins, dout.to(ins[0].dtype).contiguous(),
                                    *ctx.args, seed)
        return tuple(g.to(t.dtype) for g, t in zip(grads, ins)) \
            + (None, None, None, None)


def attention_block(c: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                    wv: torch.Tensor, wo: torch.Tensor, krel: torch.Tensor,
                    n_batch: int, nheads: int, rate: float = 0.0,
                    seed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Differentiable block, ``c (n_batch*S, D) -> c + attention (K,
    n_batch*S, D)`` in c's dtype; the weights and krel in c's dtype.

    ``rate > 0`` drops attention probabilities (training) with ``seed``, an
    int64 tensor of shape (1,) on c's device."""
    dropout.check_rate(rate, seed, _NAME)
    return _AttentionBlock.apply(c, wq, wk, wv, wo, krel, seed, n_batch,
                                 nheads, rate)


attention_block.launches = 0
