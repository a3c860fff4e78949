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

The body (csrc/conv_ln.cuh) runs the conv and its two gradients as
implicit GEMMs on csrc/gemm_tc.cuh, x read in place through the conv's
window: the forward one launch with the norm, the affine and the ReLU in
its epilogue, the backward a rows pass (dh and the vectors' parts), dx and
dW.  The forward keeps yn (float32) and 1 / std for the backward (``(B,
out_t, C)`` and ``(B, out_t)`` float32: 63 MB over encoder layers 1-4 at B
32), where the JAX kernel recomputes the conv.  Float32 operands run as
bf16 planes, with ``PRODUCTS`` split products a GEMM:
:func:`conv_ln_split` and :func:`conv_ln_bwd_split` write that arithmetic
plainly.

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

from . import _build, ffn

_NAME = "conv_ln_relu_fwd"
_BWD_NAME = "conv_ln_relu_bwd"

# Split products a float32 GEMM sums (csrc/conv_ln.cuh): the forward's conv
# ("fwd") 6, float32's own rounding; dx and dW 3.
PRODUCTS = {"fwd": 6, "dx": 3, "dw": 3}


def out_frames(T: int, kernel: int, stride: int, pad: int) -> int:
    return (T + 2 * pad - kernel) // stride + 1


def fused_conv_supported(c_in: int, c_out: int, kernel: int, stride: int,
                         pad: int, T: int) -> bool:
    """The kernels' own conditions: kernel == 2*stride (each input row
    meets exactly two frames, so dx is a two-term gather), one width C =
    c_in = c_out that is a multiple of 64 (kept from the first design; the
    body needs C % 8, x's 16-byte chunks on one side of the padding) and
    at most 256 (the forward's row tile holds every channel), and at
    least one output frame.  The waveform layer (c_in = 1) fails the
    width."""
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


def _dh(yhat, inv, nw, nb, dy, dt):
    """(dh rounded to dt, then float32; dyb): the ReLU, the affine and the
    ddof = 1 ChannelNorm chain of ``_bwd_kernel``."""
    C = yhat.shape[-1]
    nwf = nw.float()
    dyb = torch.where(yhat * nwf + nb.float() > 0.0, dy.float(), 0.0)
    g = dyb * nwf
    m1 = g.mean(dim=-1, keepdim=True)
    m2 = (g * yhat).mean(dim=-1, keepdim=True) * (C / (C - 1.0))
    return ((g - m1 - yhat * m2) * inv).to(dt).float(), dyb


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
    dh, dyb = _dh(yhat, inv, nw, nb, dy, dt)
    dfr = (dh @ w.float().t()).reshape(B, out_t, kernel, C)
    dxp = torch.zeros((B, T + 2 * pad, C), dtype=torch.float32,
                      device=x.device)
    span = stride * (out_t - 1) + 1
    for tap in range(kernel):
        dxp[:, tap:tap + span:stride] += dfr[:, :, tap]
    dw = fr.reshape(-1, kernel * C).t() @ dh.reshape(-1, C)
    return (dxp[:, pad:pad + T].to(dt), dw, dh.sum(dim=(0, 1)),
            (dyb * yhat).sum(dim=(0, 1)), dyb.sum(dim=(0, 1)))


def _mm(a: torch.Tensor, b: torch.Tensor, products: int) -> torch.Tensor:
    """a @ b as a K7 GEMM forms it: float32 operands as ``products`` split
    products of bf16 planes (ffn.split_matmul), bf16 ones (products 1) as
    one product summed in float32."""
    if products > 1:
        return ffn.split_matmul(a.float(), b.float(), products)
    return a.float() @ b.float()


def _split_fwd(x, w, bias, nw, nb, stride: int, kernel: int, pad: int,
               eps: float):
    """(out, yn, 1/std) as the kernel forms them."""
    P = PRODUCTS if x.dtype == torch.float32 else dict.fromkeys(PRODUCTS, 1)
    h = _mm(_frames(x, kernel, stride, pad), w, P["fwd"]) + bias.float()
    yhat, inv = _norm(h, eps)
    out = torch.relu(yhat * nw.float() + nb.float()).to(x.dtype)
    return out, yhat, inv


def conv_ln_split(x, w, bias, nw, nb, stride: int, kernel: int, pad: int,
                  eps: float = 1e-5) -> torch.Tensor:
    """The forward's arithmetic written plainly (csrc/conv_ln_fwd.cu): the
    conv as ``PRODUCTS["fwd"]`` split products in float32 (one bf16
    product in bf16), then the norm, the affine and the ReLU in float32.
    For tests and measurements only: the card runs the kernel."""
    return _split_fwd(x, w, bias, nw, nb, stride, kernel, pad, eps)[0]


def conv_ln_bwd_split(x, w, bias, nw, nb, dy, stride: int, kernel: int,
                      pad: int, eps: float = 1e-5
                      ) -> Tuple[torch.Tensor, ...]:
    """The backward's arithmetic written plainly (csrc/conv_ln_bwd.cu),
    from the forward's yn and 1/std: dh rounded to x's dtype, dx as the
    padded input's block rows ``[dh[u] | dh[u-1]] . [W_top ; W_bottom]^T``
    and dW as ``frames^T . dh``, each ``PRODUCTS`` split products in
    float32 (one bf16 product in bf16).  Returns what
    :func:`conv_ln_relu_bwd_ref` does.  For tests and measurements only."""
    dt = x.dtype
    P = PRODUCTS if dt == torch.float32 else dict.fromkeys(PRODUCTS, 1)
    B, T, C = x.shape
    _, yhat, inv = _split_fwd(x, w, bias, nw, nb, stride, kernel, pad, eps)
    dh, dyb = _dh(yhat, inv, nw, nb, dy, dt)
    out_t, sC = dh.shape[1], stride * C
    n_u = (T - 1 + pad) // stride + 1
    cur, prev = (torch.zeros((B, n_u, C), dtype=torch.float32,
                             device=x.device) for _ in range(2))
    n = min(n_u, out_t)
    cur[:, :n] = dh[:, :n]
    n = min(n_u, out_t + 1)
    prev[:, 1:n] = dh[:, :n - 1]
    wf = w.float()
    dxb = _mm(torch.cat([cur, prev], dim=-1),
              torch.cat([wf[:sC].t(), wf[sC:].t()]), P["dx"])
    dx = dxb.reshape(B, n_u * stride, C)[:, pad:pad + T].to(dt)
    fr = _frames(x, kernel, stride, pad).reshape(-1, kernel * C)
    dw = _mm(fr.t(), dh.reshape(-1, C), P["dw"])
    return (dx, dw, dh.sum(dim=(0, 1)), (dyb * yhat).sum(dim=(0, 1)),
            dyb.sum(dim=(0, 1)))


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
                     eps: float = 1e-5):
    """Forward: ``(out, saved)``, out (B, out_t, C) in x's dtype and
    ``saved`` the residuals the backward reads, ``(yn (B, out_t, C), inv
    (B, out_t))`` float32 (None on the CPU, whose plain backward
    recomputes them).  CPU tensors run :func:`conv_ln_relu_ref`; CUDA
    tensors launch the kernel and add one to ``conv_ln_relu.launches``."""
    vecs = (bias, nw, nb)
    if not _build.runs_kernel(_NAME, x, w, *vecs):
        return conv_ln_relu_ref(x, w, bias, nw, nb, stride, kernel, pad,
                                eps), None
    out_t = _check(_NAME, x, w, vecs, stride, kernel, pad)
    _build.check_inputs(_NAME, x.dtype, x=x, w=w)
    _build.require_aligned(_NAME, x=x, w=w)
    B, T, C = x.shape
    lib = _build.library()
    code = _build.DTYPE_CODES[x.dtype]
    bias, nw, nb = (v.float().contiguous() for v in vecs)
    dev = x.device
    out = torch.empty((B, out_t, C), dtype=x.dtype, device=dev)
    yn = torch.empty((B, out_t, C), dtype=torch.float32, device=dev)
    inv = torch.empty((B, out_t), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        # in float32, the bf16 planes of x and w
        scratch = _build.scratch(lib.cpc_conv_ln_fwd_scratch(
            B, T, C, stride, pad, code), dev)
        status = lib.cpc_conv_ln_fwd(
            x.data_ptr(), w.data_ptr(), bias.data_ptr(), nw.data_ptr(),
            nb.data_ptr(), out.data_ptr(), yn.data_ptr(), inv.data_ptr(),
            _build.ptr(scratch), B, T, C, stride, pad, float(eps), code,
            _build.stream(dev))
    _build.check(status, _NAME)
    conv_ln_relu.launches += 1
    return out, (yn, inv)


def conv_ln_relu_bwd(x, w, bias, nw, nb, dy,
                     saved: Optional[Tuple[torch.Tensor, torch.Tensor]],
                     stride: int, kernel: int, pad: int, eps: float = 1e-5
                     ) -> Tuple[torch.Tensor, ...]:
    """Backward: dx in x's dtype and float32 (dw, db, dnw, dnb).
    ``saved``: the residuals :func:`conv_ln_relu_fwd` returned at the same
    inputs; CUDA tensors need them.  CPU tensors run
    :func:`conv_ln_relu_bwd_ref`, which recomputes them (``saved`` is not
    read); CUDA tensors launch the kernels and add one to
    ``conv_ln_relu_bwd.launches``."""
    vecs = (bias, nw, nb)
    if not _build.runs_kernel(_BWD_NAME, x, w, dy, *vecs):
        return conv_ln_relu_bwd_ref(x, w, bias, nw, nb, dy, stride, kernel,
                                    pad, eps)
    out_t = _check(_BWD_NAME, x, w, vecs, stride, kernel, pad, (dy,))
    _build.check_inputs(_BWD_NAME, x.dtype, x=x, w=w, dy=dy)
    _build.require_aligned(_BWD_NAME, x=x, w=w, dy=dy)
    _build.require(saved is not None, _BWD_NAME,
                   "no residuals: pass what conv_ln_relu_fwd returned")
    yn, inv = saved
    B, T, C = x.shape
    _build.require(tuple(yn.shape) == (B, out_t, C)
                   and tuple(inv.shape) == (B, out_t), _BWD_NAME,
                   f"saved shapes yn {tuple(yn.shape)}, inv "
                   f"{tuple(inv.shape)}")
    _build.check_inputs(_BWD_NAME, torch.float32, yn=yn, inv=inv)
    lib = _build.library()
    code = _build.DTYPE_CODES[x.dtype]
    nw, nb = (v.float().contiguous() for v in (nw, nb))
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    vout = torch.empty((3, C), **f32)
    dw = torch.empty((kernel * C, C), **f32)
    with torch.cuda.device(dev):
        # dh (or its planes), the parts of the vectors and of dW and, in
        # float32, the bf16 planes of x and w
        scratch = _build.scratch(lib.cpc_conv_ln_bwd_scratch(
            B, T, C, stride, pad, code), dev)
        status = lib.cpc_conv_ln_bwd(
            x.data_ptr(), w.data_ptr(), nw.data_ptr(), nb.data_ptr(),
            dy.data_ptr(), yn.data_ptr(), inv.data_ptr(), dx.data_ptr(),
            vout.data_ptr(), dw.data_ptr(), _build.ptr(scratch), B, T, C,
            stride, pad, code, _build.stream(dev))
    _build.check(status, _BWD_NAME)
    conv_ln_relu_bwd.launches += 1
    db, dnw, dnb = vout
    return dx, dw, db, dnw, dnb


conv_ln_relu_bwd.launches = 0


class _ConvLnRelu(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, bias, nw, nb, stride, kernel, pad, eps):
        out, saved = conv_ln_relu_fwd(x, w, bias, nw, nb, stride, kernel,
                                      pad, eps)
        ctx.save_for_backward(x, w, bias, nw, nb, *(saved or ()))
        ctx.args = (stride, kernel, pad, eps)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, w, bias, nw, nb, *saved = ctx.saved_tensors
        ins = (x, w, bias, nw, nb)
        grads = conv_ln_relu_bwd(*ins, dy.to(x.dtype).contiguous(),
                                 tuple(saved) or None, *ctx.args)
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
