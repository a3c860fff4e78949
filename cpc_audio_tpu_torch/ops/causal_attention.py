"""Causal attention with a dense bias: the K5 kernels and their plain
versions.

Counterpart of ``cpc_audio_tpu/ops/pallas/attention.py``
``fused_causal_attention`` and its custom VJP, the attention of the
transformer AR (``models/transformer.py``).  q, k, v are ``(N, S, dk)``
with ``N = B * nheads``, bias is ``(N, S, S)``::

    s[i, j] = (q_i . k_j + bias[i, j]) / sqrt(dk),  j <= i
    o_i = round(softmax_j(s[i]) * dropout[i]) . v

where round() is the rounding of the probabilities to the input dtype,
as the Pallas kernel casts them before ``. v``.  The JAX kernel pads S to
a multiple of 8 (and to 128 past 64) for the TPU's tiles; these take S as
it is.  Dropout (training) drops the probabilities with the
counter-based bits of ``ops/dropout.py`` at the AR attention site, keyed
on (layer, n, i * S + j).

The backward recomputes p and gives dq, dk, dv and ``dbias = ds`` in the
input dtype; dbias is exactly 0 above the diagonal, where the caller's
skewed Shaw bias holds values of other positions.

The kernels take dk <= 128 (a multiple of 8 in bf16, as the JAX
package's own gate ``fused_attention_supported`` asks) and S <= 512;
:func:`supported` says so without a card, for the model builder's check
of a config.

:func:`causal_attention` is the differentiable entry point: its forward
runs the K5 forward kernel (csrc/causal_attention_fwd.cu, counted in
``causal_attention_fwd.launches``), its backward the K5 backward kernel
(csrc/causal_attention_bwd.cu, counted in
``causal_attention_bwd.launches``).  CPU tensors take the plain versions.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from . import _build, dropout

_NAME = "causal_attention_fwd"
_BWD_NAME = "causal_attention_bwd"

def _probs(q: torch.Tensor, k: torch.Tensor,
           bias: torch.Tensor) -> torch.Tensor:
    """Causal softmax probabilities (N, S, S), float32."""
    S, dk = q.shape[-2:]
    s = (q.float() @ k.float().transpose(-1, -2) + bias.float()) \
        / math.sqrt(dk)
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    return torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)


def causal_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: torch.Tensor, rate: float = 0.0,
                         seed: Optional[torch.Tensor] = None,
                         layer: int = 0) -> torch.Tensor:
    """Plain version (``_fwd_kernel``, attention.py:81-93): float32 scores
    and softmax; the dropped probabilities are rounded to the input dtype
    before ``. v``.  Differentiable by torch autograd."""
    N, S, _ = q.shape
    p = _probs(q, k, bias)
    mask = dropout.ar_attention_mask(seed, rate, layer, N, S, q.device)
    if mask is not None:
        p = p * mask
    return (p.to(q.dtype).float() @ v.float()).to(q.dtype)


def causal_attention_bwd_ref(q, k, v, bias, dout, rate: float = 0.0,
                             seed: Optional[torch.Tensor] = None,
                             layer: int = 0) -> Tuple[torch.Tensor, ...]:
    """Plain backward, the math of ``_bwd_kernel`` (attention.py:96-130):
    (dq, dk, dv, dbias), each in its input's dtype."""
    N, S, dk = q.shape
    p = _probs(q, k, bias)
    mask = dropout.ar_attention_mask(seed, rate, layer, N, S, q.device)
    pd = p if mask is None else p * mask
    do = dout.float()
    dv = pd.transpose(-1, -2) @ do
    dp = do @ v.float().transpose(-1, -2)
    if mask is not None:
        dp = dp * mask
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) / math.sqrt(dk)
    dq = ds @ k.float()
    dkk = ds.transpose(-1, -2) @ q.float()
    return (dq.to(q.dtype), dkk.to(k.dtype), dv.to(v.dtype),
            ds.to(bias.dtype))


MAX_S = 512
MAX_DK = 128


def supported(S: int, dk: int,
              dtype: torch.dtype = torch.bfloat16) -> Optional[str]:
    """Why the kernels refuse a sequence length S and head width dk in
    ``dtype``, or None: dk up to 128, in bf16 a multiple of 8 (the
    tensor-core body stages rows 16 bytes at a time and pads dk to 32, 64
    or 128), 0 < S <= 512 (JAX's gate pads S to at most 512)."""
    if dtype == torch.bfloat16 and dk % 8 != 0:
        return (f"head width dk={dk} must be a multiple of 8 in bf16 "
                f"(up to {MAX_DK})")
    if not 0 < dk <= MAX_DK:
        return f"head width dk={dk} must be in [1, {MAX_DK}]"
    if not 0 < S <= MAX_S:
        return f"sequence length S={S} must be in [1, {MAX_S}]"
    return None


def _check(name: str, q, k, v, bias, others=()) -> Tuple[int, int, int]:
    _build.require(q.dim() == 3, name, f"q must be (N, S, dk), got "
                   f"{tuple(q.shape)}")
    N, S, dk = q.shape
    _build.require(all(tuple(t.shape) == tuple(q.shape)
                       for t in (k, v) + tuple(others))
                   and tuple(bias.shape) == (N, S, S), name,
                   f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                   f"{tuple(v.shape)}, bias {tuple(bias.shape)}")
    why = supported(S, dk, q.dtype)
    _build.require(N > 0 and why is None, name, why or f"N={N}")
    return N, S, dk


def causal_attention_fwd(q, k, v, bias, rate: float = 0.0,
                         seed: Optional[torch.Tensor] = None,
                         layer: int = 0) -> torch.Tensor:
    """Forward: (N, S, dk) in the input dtype.  CPU tensors run
    :func:`causal_attention_ref`; CUDA tensors launch the kernel and add
    one to ``causal_attention_fwd.launches``."""
    dropout.check_rate(rate, seed, _NAME)
    if not _build.runs_kernel(_NAME, q, k, v, bias,
                              *dropout.seed_tensors(rate, seed)):
        return causal_attention_ref(q, k, v, bias, rate, seed, layer)
    N, S, dk = _check(_NAME, q, k, v, bias)
    _build.check_inputs(_NAME, q.dtype, q=q, k=k, v=v, bias=bias)
    _build.require_aligned(_NAME, q=q, k=k, v=v, bias=bias)
    lib = _build.library()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        status = lib.cpc_causal_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(), N, S, dk, layer,
            *dropout.kernel_args(rate, seed), _build.DTYPE_CODES[q.dtype],
            _build.stream(q.device))
    _build.check(status, _NAME)
    causal_attention_fwd.launches += 1
    return out


causal_attention_fwd.launches = 0


def causal_attention_bwd(q, k, v, bias, dout, rate: float = 0.0,
                         seed: Optional[torch.Tensor] = None,
                         layer: int = 0) -> Tuple[torch.Tensor, ...]:
    """Backward: (dq, dk, dv, dbias) in the input dtype.  CPU tensors run
    :func:`causal_attention_bwd_ref`; CUDA tensors launch the kernel and
    add one to ``causal_attention_bwd.launches``."""
    dropout.check_rate(rate, seed, _BWD_NAME)
    if not _build.runs_kernel(_BWD_NAME, q, k, v, bias, dout,
                              *dropout.seed_tensors(rate, seed)):
        return causal_attention_bwd_ref(q, k, v, bias, dout, rate, seed,
                                        layer)
    N, S, dk = _check(_BWD_NAME, q, k, v, bias, (dout,))
    _build.check_inputs(_BWD_NAME, q.dtype, q=q, k=k, v=v, bias=bias,
                        dout=dout)
    _build.require_aligned(_BWD_NAME, q=q, k=k, v=v, bias=bias, dout=dout)
    lib = _build.library()
    dq, dkk, dv = (torch.empty_like(q) for _ in range(3))
    dbias = torch.empty_like(bias)      # every element is written
    # the bf16 rows' statistics, or the float32 p * r tiles past shared
    # memory (csrc/causal_attention_bwd.cu)
    n_scratch = lib.cpc_causal_attention_bwd_scratch(
        N, S, dk, _build.DTYPE_CODES[q.dtype])
    scratch = torch.empty(n_scratch, dtype=torch.float32,
                          device=q.device) if n_scratch else None
    with torch.cuda.device(q.device):
        status = lib.cpc_causal_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            dout.data_ptr(), dq.data_ptr(), dkk.data_ptr(), dv.data_ptr(),
            dbias.data_ptr(), _build.ptr(scratch), N, S, dk, layer,
            *dropout.kernel_args(rate, seed), _build.DTYPE_CODES[q.dtype],
            _build.stream(q.device))
    _build.check(status, _BWD_NAME)
    causal_attention_bwd.launches += 1
    return dq, dkk, dv, dbias


causal_attention_bwd.launches = 0


class _CausalAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, bias, seed, rate, layer):
        ctx.save_for_backward(q, k, v, bias, seed)
        ctx.args = (rate, layer)
        return causal_attention_fwd(q, k, v, bias, rate, seed, layer)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, seed = ctx.saved_tensors
        rate, layer = ctx.args
        dq, dk, dv, dbias = causal_attention_bwd(
            q, k, v, bias, dout.to(q.dtype).contiguous(), rate, seed, layer)
        return dq, dk, dv, dbias, None, None, None


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor, rate: float = 0.0,
                     seed: Optional[torch.Tensor] = None,
                     layer: int = 0) -> torch.Tensor:
    """Differentiable attention, (N, S, dk) in the input dtype.

    ``rate > 0`` drops probabilities (training) with ``seed``, an int64
    tensor of shape (1,) on the inputs' device; ``layer`` keys the AR
    layer's dropout bits."""
    dropout.check_rate(rate, seed, _NAME)
    return _CausalAttention.apply(q, k, v, bias, seed, rate, layer)
