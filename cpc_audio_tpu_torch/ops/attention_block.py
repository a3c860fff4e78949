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

The body (csrc/attention_block_tc.cuh) composes the port's two
tensor-core bodies: the projections, Wo with the residual, and the
backward's dy, weight gradients and dcp as GEMMs on csrc/gemm_tc.cuh, one
launch each over every head stack, and the attention as K2's tensor-core
body, reached from K6's own C entry points (so K2's launch counts here do
not move).  The forward keeps q, k, v and y for the backward
(``4 K M D`` values: 91 MB in bf16, 182 MB in float32 at the train shape
K 12, M 3712, D 256), where the JAX kernel recomputes them.  Float32
operands run as three bf16 planes each, with ``PRODUCTS`` split products
a GEMM: :func:`attention_block_split` and :func:`attention_block_bwd_split`
write that arithmetic plainly.

:func:`attention_block` is the differentiable entry point: its forward
runs the K6 forward (csrc/attention_block_fwd.cu, counted in
``attention_block.launches``), its backward the K6 backward
(csrc/attention_block_bwd.cu, counted in ``attention_block_bwd.launches``),
which returns ``dc = sum_k (dcp[k] + dout[k])`` with the sum taken here, as
the JAX package takes it outside its kernel.  CPU tensors take the plain
versions.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build, dropout, ffn
from .head_attention import (relpos_attention_bwd_ref,
                             relpos_attention_bwd_split, relpos_attention_ref,
                             relpos_attention_split)

_NAME = "attention_block_fwd"
_BWD_NAME = "attention_block_bwd"
# the longest S the K6 body is checked at on the card
# (csrc/attention_block_tc.cuh `takes`); K2's own reaches further
MAX_S = 1024

# Split products a float32 GEMM sums (csrc/attention_block_tc.cuh): the
# projections ("proj"), y . Wo ("out"), dout . Wo^T ("dy") and the weight
# gradients ("dw") 6, float32's own rounding; dcp 3.  K2's attention keeps
# its own (6 forward, 3 backward).
PRODUCTS = {"proj": 6, "out": 6, "dy": 6, "dw": 6, "dcp": 3}


def attention_block_supported(S: int, nheads: int, dk: int) -> bool:
    """Whether the heads run K6 at (S, nheads, dk): where the JAX package
    takes its whole-block kernel (at the default config, S 116 and 8 x 32,
    both take it; at --hiddenEncoder 512, 8 x 64, both refuse), by the
    conditions the port's first K6 body was built to: dk a multiple of 16,
    D = nheads*dk a multiple of 64 and at most 256, S (rounded up to 16)
    times D at most 32768, and 4 (2 S^2 + 5 S (dk + 1)) + 16384 bytes
    within 227 KB.  Kept as they were, so that the heads take the block
    exactly where they did; the body itself takes more (:func:`supported`:
    any S up to 1024)."""
    D = nheads * dk
    smem = 4 * (2 * S * S + 5 * S * (dk + 1)) + 16384
    return (S > 0 and dk % 16 == 0 and D % 64 == 0 and D <= 256
            and -(-S // 16) * 16 * D <= 32768 and smem <= _build.SMEM_LIMIT)


def supported(S: int, nheads: int, dk: int) -> Optional[str]:
    """Why the K6 body refuses (S, nheads, dk), or None: it takes S up to
    1024 (K2's tensor-core body inside it reaches 4096) and the GEMMs any
    M; dk a multiple of 16 and D a multiple of 64 up to 256 are the heads'
    gate's
    (:func:`attention_block_supported`), the C entry points' ``takes``."""
    D = nheads * dk
    if (0 < S <= MAX_S and nheads > 0 and dk > 0 and dk % 16 == 0
            and D % 64 == 0 and D <= 256):
        return None
    return (f"S={S}, nheads={nheads}, dk={dk} outside K6's shapes (dk % 16 "
            f"== 0 and D = nheads * dk a multiple of 64 up to 256, as "
            f"attention_block_supported asks; 0 < S <= {MAX_S}, the "
            f"longest checked)")


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


def _mm(a: torch.Tensor, b: torch.Tensor, products: int) -> torch.Tensor:
    """a @ b as a K6 GEMM forms it: float32 operands as ``products`` split
    products of bf16 planes (ffn.split_matmul), bf16 ones (products 1) as
    one product summed in float32."""
    if products > 1:
        return ffn.split_matmul(a.float(), b.float(), products)
    return a.float() @ b.float()


def _split_fwd(c, wq, wk, wv, wo, krel, n_batch: int, nheads: int,
               rate: float, seed: Optional[torch.Tensor]):
    """(x, q, k, v, y) as the kernel forms them."""
    dt = c.dtype
    P = PRODUCTS if dt == torch.float32 else dict.fromkeys(PRODUCTS, 1)
    q, k, v = (_mm(c, w, P["proj"]).to(dt) for w in (wq, wk, wv))
    y = relpos_attention_split(q, k, v, krel, n_batch, nheads, rate, seed)
    att = _mm(y, wo, P["out"]).to(dt)
    return (c.float() + att.float()).to(dt), q, k, v, y


def attention_block_split(c, wq, wk, wv, wo, krel, n_batch: int,
                          nheads: int, rate: float = 0.0,
                          seed: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """The forward's arithmetic written plainly
    (csrc/attention_block_fwd.cu): the projections and y . Wo as
    ``PRODUCTS`` split products in float32 (one bf16 product in bf16),
    each rounded to c's dtype, and K2's tensor-core attention
    (``head_attention.relpos_attention_split``).  For tests and
    measurements only: the card runs the kernel."""
    return _split_fwd(c, wq, wk, wv, wo, krel, n_batch, nheads, rate,
                      seed)[0]


def attention_block_bwd_split(c, wq, wk, wv, wo, krel, dout, n_batch: int,
                              nheads: int, rate: float = 0.0,
                              seed: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, ...]:
    """The backward's arithmetic written plainly
    (csrc/attention_block_bwd.cu), from the forward's q, k, v and y: dy,
    the weight gradients and dcp as ``PRODUCTS`` split products in
    float32 (one bf16 product in bf16), K2's tensor-core backward
    (``head_attention.relpos_attention_bwd_split``), and dc summed over the
    head stacks.  Returns what :func:`attention_block_bwd_ref` does.  For
    tests and measurements only."""
    dt = c.dtype
    P = PRODUCTS if dt == torch.float32 else dict.fromkeys(PRODUCTS, 1)
    _, q, k, v, y = _split_fwd(c, wq, wk, wv, wo, krel, n_batch, nheads,
                               rate, seed)
    dy = _mm(dout, wo.transpose(1, 2), P["dy"]).to(dt)
    dq, dk, dv, dkrel = relpos_attention_bwd_split(q, k, v, krel, dy,
                                                   n_batch, nheads, rate,
                                                   seed)
    ct = c.t()
    dwq, dwk, dwv = (_mm(ct, g, P["dw"]) for g in (dq, dk, dv))
    dwo = _mm(y.transpose(1, 2), dout, P["dw"])
    dcp = sum(_mm(g, w.transpose(1, 2), P["dcp"])
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
                        seed: Optional[torch.Tensor] = None):
    """Forward: ``(x, saved)``, x (K, M, D) in c's dtype and ``saved`` the
    residuals the backward reads, ``(qkv (3, K, M, D), y (K, M, D))``
    (None on the CPU, whose plain backward recomputes them).  CPU tensors
    run :func:`attention_block_ref`; CUDA tensors launch the kernels and
    add one to ``attention_block.launches``."""
    dropout.check_rate(rate, seed, _NAME)
    if not _build.runs_kernel(_NAME, c, wq, wk, wv, wo, krel,
                              *dropout.seed_tensors(rate, seed)):
        return attention_block_ref(c, wq, wk, wv, wo, krel, n_batch, nheads,
                                   rate, seed), None
    out = _forward(c, wq, wk, wv, wo, krel, n_batch, nheads, rate, seed)
    attention_block.launches += 1
    return out


def _forward(c, wq, wk, wv, wo, krel, n_batch: int, nheads: int,
             rate: float, seed: Optional[torch.Tensor]):
    """The forward kernels on CUDA tensors: x and (qkv, y)."""
    K, S, dk = _check(_NAME, c, wq, wk, wv, wo, krel, n_batch, nheads)
    _build.check_inputs(_NAME, c.dtype, c=c, wq=wq, wk=wk, wv=wv, wo=wo,
                        krel=krel)
    _build.require_aligned(_NAME, c=c, wq=wq, wk=wk, wv=wv, wo=wo)
    lib = _build.library()
    code = _build.DTYPE_CODES[c.dtype]
    M, D = c.shape
    x, y = (torch.empty((K, M, D), dtype=c.dtype, device=c.device)
            for _ in range(2))
    qkv = torch.empty((3, K, M, D), dtype=c.dtype, device=c.device)
    with torch.cuda.device(c.device):
        # K2's scratch and, in float32, the bf16 planes of c, the weights
        # and y
        scratch = _build.scratch(lib.cpc_attention_block_fwd_scratch(
            K, n_batch, S, nheads, dk, code), c.device)
        status = lib.cpc_attention_block_fwd(
            c.data_ptr(), wq.data_ptr(), wk.data_ptr(), wv.data_ptr(),
            wo.data_ptr(), krel.data_ptr(), x.data_ptr(), qkv.data_ptr(),
            y.data_ptr(), _build.ptr(scratch), K, n_batch, S, nheads, dk,
            *dropout.kernel_args(rate, seed), code, _build.stream(c.device))
    _build.check(status, _NAME)
    return x, (qkv, y)


def attention_block_bwd(c, wq, wk, wv, wo, krel, dout,
                        saved: Optional[Tuple[torch.Tensor, ...]],
                        n_batch: int, nheads: int, rate: float = 0.0,
                        seed: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, ...]:
    """Backward: dc in c's dtype and float32 (dWq, dWk, dWv, dWo, dkrel).
    ``saved``: the residuals :func:`attention_block_fwd` returned at the
    same inputs, rate and seed; CUDA tensors need them.  CPU tensors run
    :func:`attention_block_bwd_ref`, which recomputes them (``saved`` is
    not read); CUDA tensors launch the kernels and add one to
    ``attention_block_bwd.launches``."""
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
    _build.require(saved is not None, _BWD_NAME,
                   "no residuals: pass what attention_block_fwd returned")
    qkv, y = saved
    M, D = c.shape
    _build.require(tuple(qkv.shape) == (3, K, M, D)
                   and tuple(y.shape) == (K, M, D), _BWD_NAME,
                   f"saved shapes qkv {tuple(qkv.shape)}, y "
                   f"{tuple(y.shape)}")
    _build.check_inputs(_BWD_NAME, c.dtype, qkv=qkv, y=y)
    _build.require_aligned(_BWD_NAME, qkv=qkv, y=y)
    lib = _build.library()
    code = _build.DTYPE_CODES[c.dtype]
    dev = c.device
    f32 = dict(dtype=torch.float32, device=dev)
    dcp = torch.empty_like(dout)
    dkrel = torch.empty((K, dk, S), **f32)
    dw = torch.empty((4, K, D, D), **f32)
    with torch.cuda.device(dev):
        # dy, dq, dk, dv, K2's scratch and, in float32, the bf16 planes of
        # c, the weights, dout, y, dq, dk and dv
        scratch = _build.scratch(lib.cpc_attention_block_bwd_scratch(
            K, n_batch, S, nheads, dk, code), dev)
        status = lib.cpc_attention_block_bwd(
            c.data_ptr(), wq.data_ptr(), wk.data_ptr(), wv.data_ptr(),
            wo.data_ptr(), krel.data_ptr(), dout.data_ptr(), qkv.data_ptr(),
            y.data_ptr(), dkrel.data_ptr(), dw.data_ptr(), dcp.data_ptr(),
            _build.ptr(scratch), K, n_batch, S, nheads, dk,
            *dropout.kernel_args(rate, seed), code, _build.stream(dev))
    _build.check(status, _BWD_NAME)
    attention_block_bwd.launches += 1
    dwq, dwk, dwv, dwo = dw
    return _dc(dcp, dout), dwq, dwk, dwv, dwo, dkrel


attention_block_bwd.launches = 0


class _AttentionBlock(torch.autograd.Function):

    @staticmethod
    def forward(ctx, c, wq, wk, wv, wo, krel, seed, n_batch, nheads, rate):
        x, saved = attention_block_fwd(c, wq, wk, wv, wo, krel, n_batch,
                                       nheads, rate, seed)
        ctx.save_for_backward(c, wq, wk, wv, wo, krel, seed,
                              *(saved or ()))
        ctx.args = (n_batch, nheads, rate)
        return x

    @staticmethod
    def backward(ctx, dout):
        c, wq, wk, wv, wo, krel, seed, *saved = ctx.saved_tensors
        ins = (c, wq, wk, wv, wo, krel)
        grads = attention_block_bwd(*ins, dout.to(c.dtype).contiguous(),
                                    tuple(saved) or None, *ctx.args, seed)
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
