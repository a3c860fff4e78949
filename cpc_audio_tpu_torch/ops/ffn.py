"""Transformer-layer tail LN1 -> FFN -> residual -> LN2: the K3 kernels and
their plain versions.

Counterpart of ``cpc_audio_tpu/ops/pallas/ffn.py`` ``fused_layer_tail``
and its custom VJP.  Per head k, for ``x (K, M, D)``::

    y = LN1(x);  out = LN2(y + (relu(y . W1[k] + b1[k]) * r) . W2[k] + b2[k])

with r the dropout factor of the hidden (training; ``ops/dropout.py``,
keyed on (k, row, f)).  LayerNorm statistics are float32 with the biased
variance and ``eps`` added to it.  ``y`` and the hidden are rounded to the
input dtype before they enter a product, as in the JAX kernel.  The LN
parameters and biases may be any float dtype (they are used in float32);
``w1``/``w2`` are in x's dtype.

:func:`layer_tail` is the differentiable entry point: its forward runs the
K3 forward kernels (counted in ``layer_tail.launches``): LN1 and two
tensor-core GEMMs with fused epilogues; its backward the K3 backward
kernels (counted in ``layer_tail_bwd.launches``): LN1 and six such GEMMs.
Both directions are one body on one GEMM core (csrc/layer_tail_tc.cu),
whose float32 operands are split into bf16 planes
(:func:`layer_tail_fwd_split` and :func:`layer_tail_bwd_split` write that
arithmetic plainly).  CPU tensors take the plain versions.

The kernels take D any multiple of 8 (the JAX package trains every such
width, on its Pallas tail where its VMEM gate takes the shape and on its
jnp tail elsewhere; past D 1024 the kernels' D-wide epilogues cross
column tiles through row and column passes) and F a multiple of 64
(bf16) or 32 (float32); :func:`supported` says so without a card, for
the criterion builder's check of a config.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build, dropout

_NAME = "layer_tail_fwd"
_BWD_NAME = "layer_tail_bwd"

MULTIPLE = 8          # D: whole 16-byte chunks of a bf16 row
ROW_TILE_MAX_D = 1024  # the widest D whose G2/G4 row tile holds a row


def _width_class(D: int) -> int:
    """The kernels' tiles by D: 0 up to 256, 1 up to 512, 2 up to 1024, 3
    past it, the wide body (``cpc::tail_width_class``,
    csrc/layer_tail_tc.cu)."""
    return (0 if D <= 256 else 1 if D <= 512 else 2 if D <= ROW_TILE_MAX_D
            else 3)


# csrc/layer_tail_tc.cu's G2/G4 tiles: (BM, BN, depth of a slot, slots),
# by width class: a row tile holding all D columns, or past 1024 the wide
# body's 128 x 128 tile
_ROW_TILES = ((128, 256, 32, 3), (64, 512, 32, 3), (32, 1024, 16, 4),
              (128, 128, 64, 3))


def _bwd_smem(D: int, F: int, dtype: torch.dtype) -> int:
    """Shared memory of the backward's largest block, as
    cpc_layer_tail_bwd_smem reports it (the same at every F and in both
    dtypes): a cp.async ring of bf16 tiles whose rows carry 8 elements of
    padding (csrc/gemm_tc.cuh), for each GEMM (BM, BN, depth of a slot,
    slots, A stored k-major, B stored n-major): G1, G3, G5 and G6 on
    128 x 128 tiles, 3 slots 64 deep, G2 and G4 on the row tile of D's
    class (``_ROW_TILES``).  The forward's blocks are among these: its G1
    is the backward's, its G2 takes the backward's G2 tile."""
    row = _ROW_TILES[_width_class(D)]
    gemms = ((128, 128, 64, 3, False, False), (128, 128, 64, 3, False, True),
             (128, 128, 64, 3, True, False), (*row, False, False),
             (*row, False, True))

    def ring(bm: int, bn: int, bk: int, slots: int, a_kmajor: bool,
             b_nmajor: bool) -> int:
        a = bk * (bm + 8) if a_kmajor else bm * (bk + 8)
        b = bn * (bk + 8) if b_nmajor else bk * (bn + 8)
        return slots * 2 * (a + b)
    return max(ring(*g) for g in gemms)


def supported(D: int, F: int, dtype: torch.dtype) -> Optional[str]:
    """Why the kernels refuse a model width D and FFN width F in
    ``dtype``, or None."""
    if D <= 0 or D % MULTIPLE != 0:
        return f"model width D={D} must be a positive multiple of {MULTIPLE}"
    chunk = 64 if dtype == torch.bfloat16 else 32
    if F <= 0 or F % chunk != 0:
        return f"FFN width F={F} must be a multiple of {chunk}"
    smem = _bwd_smem(D, F, dtype)
    if smem > _build.SMEM_LIMIT:
        return (f"D={D}, F={F} needs {smem} bytes of shared memory in the "
                f"backward (at most {_build.SMEM_LIMIT})")
    return None

def _ln(x32: torch.Tensor, eps: float):
    """(yhat, 1/std) of a float32 (or float64) (K, M, D) LayerNorm, biased
    variance."""
    mean = x32.mean(dim=-1, keepdim=True)
    xc = x32 - mean
    inv = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    return xc * inv, inv


def _affine(yhat, w, b):
    return yhat * w.to(yhat.dtype)[:, None] + b.to(yhat.dtype)[:, None]


def _ln_bwd(dout32, yhat, inv, w):
    """LayerNorm input gradient (ffn.py:63-68)."""
    dy = dout32 * w.to(dout32.dtype)[:, None]
    m1 = dy.mean(dim=-1, keepdim=True)
    m2 = (dy * yhat).mean(dim=-1, keepdim=True)
    return (dy - m1 - yhat * m2) * inv


def layer_tail_ref(x, ln1w, ln1b, w1, b1, w2, b2, ln2w, ln2b,
                   eps: float = 1e-5, rate: float = 0.0,
                   seed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version with float32 products (exact for bf16 inputs).
    Differentiable by torch autograd.  Float64 inputs are taken in
    float64 throughout: the exact version the float32 kernel is measured
    against."""
    dt = x.dtype
    acc = torch.float64 if dt == torch.float64 else torch.float32
    K, M, _ = x.shape
    y = _affine(_ln(x.to(acc), eps)[0], ln1w, ln1b).to(dt).to(acc)
    h = torch.relu(y @ w1.to(acc) + b1.to(acc)[:, None])
    mask = dropout.ffn_mask(seed, rate, K, M, w1.shape[-1], x.device)
    if mask is not None:
        h = h * mask
    f = h.to(dt).to(acc) @ w2.to(acc) + b2.to(acc)[:, None]
    return _affine(_ln(y + f, eps)[0], ln2w, ln2b).to(dt)


def layer_tail_bwd_ref(x, ln1w, ln1b, w1, b1, w2, b2, ln2w, ln2b, dout,
                       eps: float = 1e-5, rate: float = 0.0,
                       seed: Optional[torch.Tensor] = None,
                       force_live: Optional[Tuple[torch.Tensor,
                                                  torch.Tensor]] = None
                       ) -> Tuple[torch.Tensor, ...]:
    """Plain backward, the math of ``_tail_bwd_kernel`` (ffn.py:121-208).
    Returns dx (x's dtype) and float32 (dln1w, dln1b, dw1, db1, dw2, db2,
    dln2w, dln2b), each summed over rows.  Float64 inputs are taken in
    float64 throughout: the exact version the float32 kernel is measured
    against.

    ``force_live = (units, live)``, units an (n, 3) integer tensor of (k,
    row, f) and live an (n,) bool tensor, sets those hidden units' live
    bits (kept and positive: whether dh passes the ReLU) to ``live``; the
    hidden itself is left as it is.  So a unit within rounding of the ReLU
    kink can be taken on either branch: it moves only dx, dln1w, dln1b,
    dw1 and db1."""
    dt = x.dtype
    acc = torch.float64 if dt == torch.float64 else torch.float32
    K, M, _ = x.shape
    yhat1, inv1 = _ln(x.to(acc), eps)
    y = _affine(yhat1, ln1w, ln1b).to(dt).to(acc)
    h32 = torch.relu(y @ w1.to(acc) + b1.to(acc)[:, None])
    mask = dropout.ffn_mask(seed, rate, K, M, w1.shape[-1], x.device)
    if mask is not None:
        h32 = h32 * mask
    live = h32 > 0.0                       # kept AND positive
    if force_live is not None:
        units, forced = force_live
        live = live.clone()
        live[units[:, 0], units[:, 1], units[:, 2]] = forced.to(live.device)
    h = h32.to(dt).to(acc)
    yhat2, inv2 = _ln(y + h @ w2.to(acc) + b2.to(acc)[:, None], eps)
    do = dout.to(acc)
    dy2 = _ln_bwd(do, yhat2, inv2, ln2w)
    df = dy2.to(dt).to(acc)
    dh = df @ w2.to(acc).transpose(1, 2)
    scale = 1.0 / (1.0 - rate)
    dhp = torch.where(live, dh * scale, 0.0).to(dt).to(acc)
    dy = dy2 + dhp @ w1.to(acc).transpose(1, 2)
    dx = _ln_bwd(dy, yhat1, inv1, ln1w).to(dt)
    return (dx, (dy * yhat1).sum(1), dy.sum(1),
            y.transpose(1, 2) @ dhp, dhp.sum(1),
            h.transpose(1, 2) @ df, df.sum(1),
            (do * yhat2).sum(1), do.sum(1))


# The float32 kernel's split products (csrc/gemm_tc.cuh): the (plane of
# a, plane of b) pairs of a product of 3 and of 6 split terms, smallest
# first.
SPLIT_PAIRS = {3: ((1, 0), (0, 1), (0, 0)),
               6: ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))}


def split_planes(a: torch.Tensor, n: int) -> list:
    """n bf16 planes of float32 ``a`` (as float32 tensors), each the bf16
    rounding of what the planes before it left; three hold ``a``
    exactly."""
    planes, rest = [], a.float()
    for _ in range(n):
        plane = rest.to(torch.bfloat16).float()
        planes.append(plane)
        rest = rest - plane
    return planes


def split_matmul(a: torch.Tensor, b: torch.Tensor,
                 products: int = 3) -> torch.Tensor:
    """``a @ b`` as the float32 kernel forms it: the sum of ``products``
    (3 or 6) products of bf16 planes of a and b (``SPLIT_PAIRS``), each
    exact term by term and summed in float32 (here each product apart)."""
    n = 2 if products == 3 else 3
    pa, pb = split_planes(a, n), split_planes(b, n)
    out = None
    for i, j in SPLIT_PAIRS[products]:
        term = pa[i] @ pb[j]
        out = term if out is None else out + term
    return out


def layer_tail_fwd_split(x, ln1w, ln1b, w1, b1, w2, b2, ln2w, ln2b,
                         eps: float = 1e-5, rate: float = 0.0,
                         seed: Optional[torch.Tensor] = None,
                         g1_products: int = 6) -> torch.Tensor:
    """The float32 forward kernel's arithmetic written plainly: G1 (y W1)
    as :func:`split_matmul` of ``g1_products`` split terms and G2 (h W2)
    of 3, everything else in float32.  Float32 inputs; the same output as
    :func:`layer_tail_ref`.  For tests and measurements only: the card
    runs the kernel."""
    K, M, _ = x.shape
    y = _affine(_ln(x.float(), eps)[0], ln1w, ln1b)
    h = torch.relu(split_matmul(y, w1.float(), g1_products)
                   + b1.float()[:, None])
    mask = dropout.ffn_mask(seed, rate, K, M, w1.shape[-1], x.device)
    if mask is not None:
        h = h * mask
    y2 = y + split_matmul(h, w2.float()) + b2.float()[:, None]
    return _affine(_ln(y2, eps)[0], ln2w, ln2b)


def layer_tail_bwd_split(x, ln1w, ln1b, w1, b1, w2, b2, ln2w, ln2b, dout,
                         eps: float = 1e-5, rate: float = 0.0,
                         seed: Optional[torch.Tensor] = None,
                         g1_products: int = 6) -> Tuple[torch.Tensor, ...]:
    """The float32 kernel's arithmetic written plainly: the six products
    of :func:`layer_tail_bwd_ref` as :func:`split_matmul`, G1 (y W1,
    whose sign makes the live mask) of ``g1_products`` split terms and the
    other five of 3, everything else in float32.  Float32 inputs; the same
    outputs as :func:`layer_tail_bwd_ref`.  For tests and measurements
    only: the card runs the kernel."""
    K, M, _ = x.shape
    yhat1, inv1 = _ln(x.float(), eps)
    y = _affine(yhat1, ln1w, ln1b)
    w1, w2 = w1.float(), w2.float()
    h = torch.relu(split_matmul(y, w1, g1_products) + b1.float()[:, None])
    mask = dropout.ffn_mask(seed, rate, K, M, w1.shape[-1], x.device)
    if mask is not None:
        h = h * mask
    yhat2, inv2 = _ln(y + split_matmul(h, w2) + b2.float()[:, None], eps)
    do = dout.float()
    df = _ln_bwd(do, yhat2, inv2, ln2w)
    dh = split_matmul(df, w2.transpose(1, 2))
    dhp = torch.where(h > 0.0, dh * (1.0 / (1.0 - rate)), 0.0)
    dy = df + split_matmul(dhp, w1.transpose(1, 2))
    dx = _ln_bwd(dy, yhat1, inv1, ln1w)
    return (dx, (dy * yhat1).sum(1), dy.sum(1),
            split_matmul(y.transpose(1, 2), dhp), dhp.sum(1),
            split_matmul(h.transpose(1, 2), df), df.sum(1),
            (do * yhat2).sum(1), do.sum(1))


def _check_weights(name: str, x, ln1w, ln1b, w1, b1, w2, b2, ln2w, ln2b):
    K, M, D = x.shape
    F = w1.shape[-1]
    _build.require(tuple(w1.shape) == (K, D, F)
                   and tuple(w2.shape) == (K, F, D)
                   and tuple(b1.shape) == (K, F)
                   and all(tuple(t.shape) == (K, D)
                           for t in (ln1w, ln1b, b2, ln2w, ln2b)), name,
                   f"shapes x {tuple(x.shape)}, w1 {tuple(w1.shape)}, "
                   f"w2 {tuple(w2.shape)}")
    _build.require_aligned(name, w1=w1, w2=w2)
    return K, M, D, F


def layer_tail_fwd(x, ln1w, ln1b, w1, b1, w2, b2, ln2w, ln2b,
                   rate: float = 0.0, eps: float = 1e-5,
                   seed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Forward: (K, M, D) in x's dtype.  CPU tensors run
    :func:`layer_tail_ref`; CUDA tensors launch the kernels and add one to
    ``layer_tail.launches``."""
    dropout.check_rate(rate, seed, _NAME)
    vecs = (ln1w, ln1b, b1, b2, ln2w, ln2b)
    if not _build.runs_kernel(_NAME, x, w1, w2, *vecs,
                              *dropout.seed_tensors(rate, seed)):
        return layer_tail_ref(x, ln1w, ln1b, w1, b1, w2, b2, ln2w, ln2b, eps,
                              rate, seed)
    K, M, D, F = _check_weights(_NAME, x, *vecs[:2], w1, b1, w2, *vecs[3:])
    _build.check_inputs(_NAME, x.dtype, x=x, w1=w1, w2=w2)
    _build.require(M > 0 and K > 0, _NAME, f"M={M}, K={K} out of range")
    why = supported(D, F, x.dtype)
    _build.require(why is None, _NAME, why or "")
    ln1w, ln1b, b1, b2, ln2w, ln2b = (t.float().contiguous() for t in vecs)
    lib = _build.library()
    code = _build.DTYPE_CODES[x.dtype]
    out = torch.empty_like(x)
    # the planes of y and the hidden (and, in float32, of the weights) and
    # LN1's statistics
    scratch = torch.empty(lib.cpc_layer_tail_fwd_scratch(K, M, D, F, code),
                          dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        status = lib.cpc_layer_tail_fwd(
            x.data_ptr(), ln1w.data_ptr(), ln1b.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), ln2w.data_ptr(),
            ln2b.data_ptr(), out.data_ptr(), scratch.data_ptr(), K, M, D, F,
            float(eps), *dropout.kernel_args(rate, seed), code,
            _build.stream(x.device))
    _build.check(status, _NAME)
    layer_tail.launches += 1
    return out


def layer_tail_bwd(x, ln1w, ln1b, w1, b1, w2, b2, ln2w, ln2b, dout,
                   rate: float = 0.0, eps: float = 1e-5,
                   seed: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, ...]:
    """Backward: dx in x's dtype and float32 (dln1w, dln1b, dw1, db1, dw2,
    db2, dln2w, dln2b).  CPU tensors run :func:`layer_tail_bwd_ref`; CUDA
    tensors launch the kernels and add one to ``layer_tail_bwd.launches``."""
    dropout.check_rate(rate, seed, _BWD_NAME)
    vecs = (ln1w, ln1b, b1, b2, ln2w, ln2b)
    if not _build.runs_kernel(_BWD_NAME, x, w1, w2, dout, *vecs,
                              *dropout.seed_tensors(rate, seed)):
        return layer_tail_bwd_ref(x, ln1w, ln1b, w1, b1, w2, b2, ln2w, ln2b,
                                  dout, eps, rate, seed)
    K, M, D, F = _check_weights(_BWD_NAME, x, *vecs[:2], w1, b1, w2,
                                *vecs[3:])
    _build.check_inputs(_BWD_NAME, x.dtype, x=x, w1=w1, w2=w2, dout=dout)
    _build.require(tuple(dout.shape) == tuple(x.shape), _BWD_NAME,
                   f"dout {tuple(dout.shape)} vs x {tuple(x.shape)}")
    _build.require(M > 0 and K > 0, _BWD_NAME, f"M={M}, K={K} out of range")
    why = supported(D, F, x.dtype)
    _build.require(why is None, _BWD_NAME, why or "")
    lib = _build.library()
    code = _build.DTYPE_CODES[x.dtype]
    smem = lib.cpc_layer_tail_bwd_smem(D, F, code)
    _build.require_smem(_BWD_NAME, smem, f"D={D}, F={F}")
    ln1w, ln1b, b1, b2, ln2w, ln2b = (t.float().contiguous() for t in vecs)
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    # the planes of y, df, the hidden and its gradient (and, in float32,
    # of the weights) and their companions
    scratch = torch.empty(lib.cpc_layer_tail_bwd_scratch(K, M, D, F, code),
                          dtype=torch.uint8, device=dev)
    tiles = lib.cpc_layer_tail_bwd_tiles(M, D, code)
    vec_part = torch.empty((K, tiles, 5, D), **f32)
    vec_out = torch.empty((5, K, D), **f32)
    dw1 = torch.empty((K, D, F), **f32)
    db1 = torch.empty((K, F), **f32)
    dw2 = torch.empty((K, F, D), **f32)
    with torch.cuda.device(dev):
        status = lib.cpc_layer_tail_bwd(
            x.data_ptr(), ln1w.data_ptr(), ln1b.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), ln2w.data_ptr(),
            ln2b.data_ptr(), dout.data_ptr(), dx.data_ptr(),
            vec_part.data_ptr(), vec_out.data_ptr(), dw1.data_ptr(),
            db1.data_ptr(), dw2.data_ptr(), scratch.data_ptr(), K, M, D, F,
            float(eps), *dropout.kernel_args(rate, seed), code,
            _build.stream(dev))
    _build.check(status, _BWD_NAME)
    layer_tail_bwd.launches += 1
    dln1w, dln1b, db2, dln2w, dln2b = vec_out
    return dx, dln1w, dln1b, dw1, db1, dw2, db2, dln2w, dln2b


layer_tail_bwd.launches = 0


class _LayerTail(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, ln1w, ln1b, w1, b1, w2, b2, ln2w, ln2b, seed, rate,
                eps):
        ctx.save_for_backward(x, ln1w, ln1b, w1, b1, w2, b2, ln2w, ln2b,
                              seed)
        ctx.args = (rate, eps)
        return layer_tail_fwd(x, ln1w, ln1b, w1, b1, w2, b2, ln2w, ln2b,
                              rate, eps, seed)

    @staticmethod
    def backward(ctx, dout):
        saved = ctx.saved_tensors
        rate, eps = ctx.args
        grads = layer_tail_bwd(*saved[:9], dout.to(saved[0].dtype)
                               .contiguous(), rate, eps, saved[9])
        return tuple(g.to(t.dtype) for g, t in zip(grads, saved[:9])) \
            + (None, None, None)


def layer_tail(x, ln1w, ln1b, w1, b1, w2, b2, ln2w, ln2b,
               rate: float = 0.0, eps: float = 1e-5,
               seed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Differentiable tail.  x (K, M, D); w1 (K, D, F); w2 (K, F, D); b1
    (K, F); LN params and b2 (K, D).  Returns (K, M, D) in x's dtype.

    ``rate > 0`` drops hidden units (training) with ``seed``, an int64
    tensor of shape (1,) on x's device."""
    dropout.check_rate(rate, seed, _NAME)
    return _LayerTail.apply(x, ln1w, ln1b, w1, b1, w2, b2, ln2w, ln2b, seed,
                            rate, eps)


layer_tail.launches = 0
