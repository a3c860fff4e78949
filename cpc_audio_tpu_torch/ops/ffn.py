"""Transformer-layer tail LN1 -> FFN -> residual -> LN2: the K3 kernel and
its plain version.

Counterpart of ``cpc_audio_tpu/ops/pallas/ffn.py`` ``fused_layer_tail``
(forward; dropout and the backward kernel come with the training path).
Per head k, for ``x (K, M, D)``::

    y = LN1(x);  out = LN2(y + relu(y . W1[k] + b1[k]) . W2[k] + b2[k])

LayerNorm statistics are float32 with the biased variance and ``eps``
added to it.  ``y`` and the ReLU hidden are rounded to the input dtype
before they enter a product, as in the JAX kernel.  The LN parameters and
biases may be any float dtype (they are used in float32); ``w1``/``w2``
are in x's dtype.
"""

from __future__ import annotations

import torch

from . import _build
from .head_attention import _check_rate

_NAME = "layer_tail_fwd"


def _layer_norm(x32: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                eps: float) -> torch.Tensor:
    """Per-head LayerNorm of (K, M, D) float32 with (K, D) affine."""
    mean = x32.mean(dim=-1, keepdim=True)
    xc = x32 - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return xc * torch.rsqrt(var + eps) * w.float()[:, None] \
        + b.float()[:, None]


def layer_tail_ref(x, ln1w, ln1b, w1, b1, w2, b2, ln2w, ln2b,
                   eps: float = 1e-5) -> torch.Tensor:
    """Plain version with float32 products (exact for bf16 inputs)."""
    dt = x.dtype
    y = _layer_norm(x.float(), ln1w, ln1b, eps).to(dt).float()
    h = torch.relu(y @ w1.float() + b1.float()[:, None]).to(dt).float()
    f = h @ w2.float() + b2.float()[:, None]
    return _layer_norm(y + f, ln2w, ln2b, eps).to(dt)


def layer_tail(x, ln1w, ln1b, w1, b1, w2, b2, ln2w, ln2b,
               rate: float = 0.0, eps: float = 1e-5) -> torch.Tensor:
    """x (K, M, D); w1 (K, D, F); w2 (K, F, D); b1 (K, F); LN params and
    b2 (K, D).  Returns (K, M, D) in x's dtype.

    CPU tensors run :func:`layer_tail_ref`; CUDA tensors launch the kernel
    (csrc/layer_tail_fwd.cu) and add one to ``layer_tail.launches``."""
    _check_rate(rate)
    vecs = (ln1w, ln1b, b1, b2, ln2w, ln2b)
    if not _build.runs_kernel(_NAME, x, w1, w2, *vecs):
        return layer_tail_ref(x, ln1w, ln1b, w1, b1, w2, b2, ln2w, ln2b, eps)
    K, M, D = x.shape
    F = w1.shape[-1]
    _build.check_inputs(_NAME, x.dtype, x=x, w1=w1, w2=w2)
    _build.require(tuple(w1.shape) == (K, D, F)
                   and tuple(w2.shape) == (K, F, D)
                   and tuple(b1.shape) == (K, F)
                   and all(tuple(t.shape) == (K, D)
                           for t in (ln1w, ln1b, b2, ln2w, ln2b)), _NAME,
                   f"shapes x {tuple(x.shape)}, w1 {tuple(w1.shape)}, "
                   f"w2 {tuple(w2.shape)}")
    _build.require(32 <= D <= 256 and D % 32 == 0 and F % (D // 4) == 0
                   and M > 0 and K > 0, _NAME,
                   f"D={D} must be a multiple of 32 in [32, 256] and F={F} "
                   f"a multiple of D/4")
    _build.require(x.dtype != torch.bfloat16 or F % 64 == 0, _NAME,
                   f"bf16 needs F % 64 == 0, got F={F}")
    _build.require(w1.data_ptr() % 16 == 0 and w2.data_ptr() % 16 == 0,
                   _NAME, "w1 and w2 must be 16-byte aligned")
    ln1w, ln1b, b1, b2, ln2w, ln2b = (t.float().contiguous() for t in vecs)
    out = torch.empty_like(x)
    lib = _build.library()
    with torch.cuda.device(x.device):
        status = lib.cpc_layer_tail_fwd(
            x.data_ptr(), ln1w.data_ptr(), ln1b.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), ln2w.data_ptr(),
            ln2b.data_ptr(), out.data_ptr(), K, M, D, F, float(eps),
            _build.DTYPE_CODES[x.dtype], _build.stream(x.device))
    _build.check(status, _NAME)
    layer_tail.launches += 1
    return out


layer_tail.launches = 0
