"""One fused encoder layer, strided conv -> bias -> ChannelNorm -> ReLU: the
K7 kernels and their plain versions.

Counterpart of ``cpc_audio_tpu/ops/pallas/conv_ln.py``
``fused_conv_ln_relu`` and its custom VJP, the path the JAX package takes
under ``CPC_PALLAS_CONV=1``.  Channels-last ``x (B, T, C)``, the conv
weight ``w (kernel*C, C)`` tap-major (the JAX WIO kernel reshaped; from the
port's ``(out, in, kernel)`` weight, ``w.permute(2, 1, 0).reshape(
kernel*C, C)``), ``kernel == 2*stride``::

    h   = conv(x, w, stride, pad) + bias          (float32 accumulation)
    out = round(relu((h - mean) / sqrt(var + eps) * nw + nb))

ChannelNorm over the C channels of a frame with the unbiased (ddof = 1)
variance and eps added to it (``_ln_unbiased_fwd``), output ``(B, out_t,
C)`` in x's dtype.  bias, nw and nb are used in float32.

:func:`conv_ln_relu` is the differentiable entry point: its forward runs
the K7 forward kernel (csrc/conv_ln_fwd.cu, counted in
``conv_ln_relu.launches``), its backward the K7 backward kernels
(csrc/conv_ln_bwd.cu, counted in ``conv_ln_relu_bwd.launches``).  CPU
tensors take the plain versions.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

_NAME = "conv_ln_relu_fwd"
_BWD_NAME = "conv_ln_relu_bwd"
_TARGET_BLOCKS = 264      # dW pass: about two blocks for each of 132 SMs


def out_frames(T: int, kernel: int, stride: int, pad: int) -> int:
    return (T + 2 * pad - kernel) // stride + 1


def fused_conv_supported(c_in: int, c_out: int, kernel: int, stride: int,
                         pad: int, T: int) -> bool:
    """The kernels' own conditions: kernel == 2*stride (each input row
    meets exactly two frames, so dx is a two-term gather), one width C =
    c_in = c_out that is a multiple of 64 (the staged chunks) and at most
    256 (the (64, C) float32 tile in shared memory), and at least one
    output frame.  The waveform layer (c_in = 1) fails the width."""
    return (kernel == 2 * stride and c_in == c_out and c_in % 64 == 0
            and c_in <= 256 and pad >= 0
            and out_frames(T, kernel, stride, pad) >= 1)


def supported(c_in: int, c_out: int, kernel: int, stride: int, pad: int,
              T: int) -> Optional[str]:
    """Why the kernels refuse a layer, or None
    (:func:`fused_conv_supported` with its reason)."""
    if fused_conv_supported(c_in, c_out, kernel, stride, pad, T):
        return None
    return (f"conv layer C_in={c_in}, C_out={c_out}, kernel {kernel}, "
            f"stride {stride}, pad {pad}, T={T} outside the kernel's shapes "
            f"(fused_conv_supported: kernel == 2 * stride, one width C = "
            f"C_in = C_out, a multiple of 64 up to 256)")


def _frames(x: torch.Tensor, kernel: int, stride: int,
            pad: int) -> torch.Tensor:
    """(B, out_t, kernel*C) float32 windows of x, flattened tap-major."""
    B, _, C = x.shape
    fr = F.pad(x.float(), (0, 0, pad, pad)).unfold(1, kernel, stride)
    return fr.transpose(2, 3).reshape(B, fr.shape[1], kernel * C)


def _norm(h: torch.Tensor, eps: float):
    """(yhat, 1/std) of ChannelNorm over the last axis, ddof = 1."""
    hc = h - h.mean(dim=-1, keepdim=True)
    var = (hc * hc).sum(dim=-1, keepdim=True) / (h.shape[-1] - 1)
    inv = torch.rsqrt(var + eps)
    return hc * inv, inv


def conv_ln_relu_ref(x, w, bias, nw, nb, stride: int, kernel: int, pad: int,
                     eps: float = 1e-5) -> torch.Tensor:
    """Plain version, (B, out_t, C) in x's dtype.  Differentiable by torch
    autograd."""
    h = _frames(x, kernel, stride, pad) @ w.float() + bias.float()
    yhat, _ = _norm(h, eps)
    return torch.relu(yhat * nw.float() + nb.float()).to(x.dtype)


def conv_ln_relu_bwd_ref(x, w, bias, nw, nb, dy, stride: int, kernel: int,
                         pad: int, eps: float = 1e-5
                         ) -> Tuple[torch.Tensor, ...]:
    """Plain backward, the ddof = 1 chain of ``_bwd_kernel``
    (conv_ln.py:105-167): dx in x's dtype and float32 (dw, db, dnw, dnb),
    summed over B and T.  dh is rounded to x's dtype before its products,
    as in the JAX kernel."""
    dt = x.dtype
    B, T, C = x.shape
    fr = _frames(x, kernel, stride, pad)
    out_t = fr.shape[1]
    yhat, inv = _norm(fr @ w.float() + bias.float(), eps)
    nwf = nw.float()
    dyb = torch.where(yhat * nwf + nb.float() > 0.0, dy.float(), 0.0)
    g = dyb * nwf
    m1 = g.mean(dim=-1, keepdim=True)
    m2 = (g * yhat).mean(dim=-1, keepdim=True) * (C / (C - 1.0))
    dh = ((g - m1 - yhat * m2) * inv).to(dt).float()
    dfr = (dh @ w.float().t()).reshape(B, out_t, kernel, C)
    dxp = torch.zeros((B, T + 2 * pad, C), dtype=torch.float32,
                      device=x.device)
    span = stride * (out_t - 1) + 1
    for tap in range(kernel):
        dxp[:, tap:tap + span:stride] += dfr[:, :, tap]
    dw = fr.reshape(-1, kernel * C).t() @ dh.reshape(-1, C)
    return (dxp[:, pad:pad + T].to(dt), dw, dh.sum(dim=(0, 1)),
            (dyb * yhat).sum(dim=(0, 1)), dyb.sum(dim=(0, 1)))


def _check(name: str, x, w, vecs, stride: int, kernel: int, pad: int,
           others=()) -> int:
    B, T, C = x.shape
    why = supported(C, w.shape[-1], kernel, stride, pad, T)
    _build.require(why is None, name, why or "")
    _build.require(tuple(w.shape) == (kernel * C, C)
                   and all(tuple(v.shape) == (C,) for v in vecs), name,
                   f"x {tuple(x.shape)}, w {tuple(w.shape)}, kernel "
                   f"{kernel}, stride {stride}, pad {pad}")
    out_t = out_frames(T, kernel, stride, pad)
    _build.require(all(tuple(t.shape) == (B, out_t, C) for t in others),
                   name, f"dy {[tuple(t.shape) for t in others]}")
    return out_t


def conv_ln_relu_fwd(x, w, bias, nw, nb, stride: int, kernel: int, pad: int,
                     eps: float = 1e-5) -> torch.Tensor:
    """Forward: (B, out_t, C) in x's dtype.  CPU tensors run
    :func:`conv_ln_relu_ref`; CUDA tensors launch the kernel and add one to
    ``conv_ln_relu.launches``."""
    vecs = (bias, nw, nb)
    if not _build.runs_kernel(_NAME, x, w, *vecs):
        return conv_ln_relu_ref(x, w, bias, nw, nb, stride, kernel, pad, eps)
    out_t = _check(_NAME, x, w, vecs, stride, kernel, pad)
    _build.check_inputs(_NAME, x.dtype, x=x, w=w)
    _build.require_aligned(_NAME, x=x, w=w)
    B, T, C = x.shape
    lib = _build.library()
    code = _build.DTYPE_CODES[x.dtype]
    _build.require_smem(_NAME, lib.cpc_conv_ln_fwd_smem(C, code), f"C={C}")
    bias, nw, nb = (v.float().contiguous() for v in vecs)
    out = torch.empty((B, out_t, C), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        status = lib.cpc_conv_ln_fwd(
            x.data_ptr(), w.data_ptr(), bias.data_ptr(), nw.data_ptr(),
            nb.data_ptr(), out.data_ptr(), B, T, C, stride, pad, float(eps),
            code, _build.stream(x.device))
    _build.check(status, _NAME)
    conv_ln_relu.launches += 1
    return out


def conv_ln_relu_bwd(x, w, bias, nw, nb, dy, stride: int, kernel: int,
                     pad: int, eps: float = 1e-5) -> Tuple[torch.Tensor, ...]:
    """Backward: dx in x's dtype and float32 (dw, db, dnw, dnb).  CPU
    tensors run :func:`conv_ln_relu_bwd_ref`; CUDA tensors launch the
    kernels and add one to ``conv_ln_relu_bwd.launches``."""
    vecs = (bias, nw, nb)
    if not _build.runs_kernel(_BWD_NAME, x, w, dy, *vecs):
        return conv_ln_relu_bwd_ref(x, w, bias, nw, nb, dy, stride, kernel,
                                    pad, eps)
    out_t = _check(_BWD_NAME, x, w, vecs, stride, kernel, pad, (dy,))
    _build.check_inputs(_BWD_NAME, x.dtype, x=x, w=w, dy=dy)
    _build.require_aligned(_BWD_NAME, x=x, w=w, dy=dy)
    B, T, C = x.shape
    lib = _build.library()
    code = _build.DTYPE_CODES[x.dtype]
    _build.require_smem(_BWD_NAME, lib.cpc_conv_ln_bwd_smem(C, code),
                        f"C={C}")
    bias, nw, nb = (v.float().contiguous() for v in vecs)
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    n_tiles = B * -(-out_t // 64)
    chunks = -(-B * out_t // 64)
    n_split = max(1, min(chunks, -(-_TARGET_BLOCKS // (kernel * C // 64))))
    dx = torch.empty_like(x)
    dh = torch.empty_like(dy)
    vpart = torch.empty((n_tiles, 3, C), **f32)
    vout = torch.empty((3, C), **f32)
    wpart = torch.empty((n_split, kernel * C, C), **f32)
    dw = torch.empty((kernel * C, C), **f32)
    with torch.cuda.device(dev):
        status = lib.cpc_conv_ln_bwd(
            x.data_ptr(), w.data_ptr(), bias.data_ptr(), nw.data_ptr(),
            nb.data_ptr(), dy.data_ptr(), dx.data_ptr(), dh.data_ptr(),
            vpart.data_ptr(), vout.data_ptr(), wpart.data_ptr(),
            dw.data_ptr(), B, T, C, stride, pad, n_split, float(eps), code,
            _build.stream(dev))
    _build.check(status, _BWD_NAME)
    conv_ln_relu_bwd.launches += 1
    db, dnw, dnb = vout
    return dx, dw, db, dnw, dnb


conv_ln_relu_bwd.launches = 0


class _ConvLnRelu(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, bias, nw, nb, stride, kernel, pad, eps):
        ctx.save_for_backward(x, w, bias, nw, nb)
        ctx.args = (stride, kernel, pad, eps)
        return conv_ln_relu_fwd(x, w, bias, nw, nb, stride, kernel, pad, eps)

    @staticmethod
    def backward(ctx, dy):
        ins = ctx.saved_tensors
        grads = conv_ln_relu_bwd(*ins, dy.to(ins[0].dtype).contiguous(),
                                 *ctx.args)
        return tuple(g.to(t.dtype) for g, t in zip(grads, ins)) \
            + (None, None, None, None)


def conv_ln_relu(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 nw: torch.Tensor, nb: torch.Tensor, stride: int,
                 kernel: int, pad: int, eps: float = 1e-5) -> torch.Tensor:
    """Differentiable layer: channels-last ``x (B, T, C)`` -> ``(B, out_t,
    C)`` in x's dtype; ``w (kernel*C, C)`` in x's dtype; ``bias``, ``nw``
    and ``nb (C,)``."""
    return _ConvLnRelu.apply(x, w, bias, nw, nb, stride, kernel, pad, eps)


conv_ln_relu.launches = 0
