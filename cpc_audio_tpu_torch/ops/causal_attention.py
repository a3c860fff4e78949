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

The kernels take dk <= 512 (a multiple of 8 in bf16, as the JAX
package's own gate ``fused_attention_supported`` asks) and S up to 4096,
the longest checked on the card (--sizeWindow 655360; they hold no (S, S)
tile: their scratch is O(N S dk), the dropout key i * S + j would stay in
32 bits to S 46340, and every offset into the (N, S, S) bias is 64-bit);
:func:`supported` says so without a card, for the model builder's check
of a config.  Both dtypes run one
tensor-core body; in float32 its operands are split into bf16 planes,
three in the forward (six split products a product) and two in the
backward (three) (:func:`causal_attention_split` and
:func:`causal_attention_bwd_split` write that arithmetic plainly).  Past
dk 256 (DKP 512) its tiles are 16 rows and each of the block's four warps
forms the scores over a quarter of dk, the partials summed in a fixed
order (:func:`quarter_sum`).

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

from . import _build, dropout, ffn

_NAME = "causal_attention_fwd"
_BWD_NAME = "causal_attention_bwd"

def _acc(t: torch.Tensor) -> torch.dtype:
    """The plain versions' arithmetic type: float32, or float64 for
    float64 inputs (a reference for the float32 kernels)."""
    return torch.promote_types(t.dtype, torch.float32)


def _probs(q: torch.Tensor, k: torch.Tensor,
           bias: torch.Tensor) -> torch.Tensor:
    """Causal softmax probabilities (N, S, S), float32 (float64 for
    float64 inputs)."""
    S, dk = q.shape[-2:]
    acc = _acc(q)
    s = (q.to(acc) @ k.to(acc).transpose(-1, -2) + bias.to(acc)) \
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
    acc = _acc(q)
    p = _probs(q, k, bias)
    mask = dropout.ar_attention_mask(seed, rate, layer, N, S, q.device)
    if mask is not None:
        p = p * mask
    return (p.to(q.dtype).to(acc) @ v.to(acc)).to(q.dtype)


def causal_attention_bwd_ref(q, k, v, bias, dout, rate: float = 0.0,
                             seed: Optional[torch.Tensor] = None,
                             layer: int = 0) -> Tuple[torch.Tensor, ...]:
    """Plain backward, the math of ``_bwd_kernel`` (attention.py:96-130):
    (dq, dk, dv, dbias), each in its input's dtype."""
    N, S, dk = q.shape
    acc = _acc(q)
    p = _probs(q, k, bias)
    mask = dropout.ar_attention_mask(seed, rate, layer, N, S, q.device)
    pd = p if mask is None else p * mask
    do = dout.to(acc)
    dv = pd.transpose(-1, -2) @ do
    dp = do @ v.to(acc).transpose(-1, -2)
    if mask is not None:
        dp = dp * mask
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) / math.sqrt(dk)
    dq = ds @ k.to(acc)
    dkk = ds.transpose(-1, -2) @ q.to(acc)
    return (dq.to(q.dtype), dkk.to(k.dtype), dv.to(v.dtype),
            ds.to(bias.dtype))


# bf16 planes of a float32 operand: the forward's three hold it exactly,
# the backward takes two (csrc/causal_attention_fwd.cu `kF32Planes`)
FWD_PLANES = 3
BWD_PLANES = 2


def key_tile(dk: int, planes: int) -> int:
    """Keys (and query rows) a tile of the tensor-core body at head width
    dk with operands of ``planes`` bf16 planes (1 in bf16;
    csrc/causal_attention.cuh ``Geom``): 64 where a row's planes hold at
    most 128 values, else 32; 16 past dk 256 (DKP 512, where the four
    warps share a tile's rows, a quarter of the columns each)."""
    if dk > 256:
        return 16
    dkp = next(w for w in (32, 64, 128, 256) if dk <= w)
    return 64 if planes * dkp <= 128 else 32


# the depth of one mma.sync.m16n8k16: the kernels' products go 16 columns
# (or keys) at a time
K_STEP = 16
# dk columns of a warp's partial scores at DKP 512, where the four warps
# split the reduction (csrc/causal_attention.cuh `kSplitK`)
QUARTER = 128


def quarter_sum(mm, a, b, dk: int):
    """``mm(a, b)``, a product over dk (a's last axis, b's second last),
    as the tensor-core bodies form it at head width dk: whole up to dk
    256; past it (DKP 512) as four partials over the 128-column quarters
    of dk, each ``mm`` of its slices (a quarter past dk is empty: zero),
    summed quarter 0 + 1 + 2 + 3; past dk 512 (K2's cluster body) each
    512-column slab so, and the slabs summed 0 + 1 + ... in order, as the
    CTAs' sums meet in every CTA."""
    if dk <= 256:
        return mm(a, b)
    out = None
    for c in range(0, dk, 4 * QUARTER):
        slab = None
        for w in range(c, c + 4 * QUARTER, QUARTER):
            part = mm(a[..., w:w + QUARTER], b[..., w:w + QUARTER, :])
            slab = part if slab is None else slab + part
        out = slab if out is None else out + slab
    return out


def kstep_products(a_planes, b_planes, acc: torch.Tensor,
                   descending: bool = False) -> torch.Tensor:
    """``acc`` plus the split products of bf16 planes ``a_planes`` (.., M,
    K) and ``b_planes`` (.., K, N), plane i of a times plane j of b for
    i + j < planes, as the forward kernel adds them into its one float32
    accumulator (csrc/causal_attention.cuh ``rows_dot_rows``,
    ``acc_times_rows``): K_STEP of the depth at a time, in each the pairs
    by increasing i + j, i ascending within a diagonal (``descending``:
    i descending, as p . v does).  Each K_STEP product is a float32 matmul
    here; the tensor cores' own rounding of it is not reproduced."""
    n = len(a_planes)
    for k0 in range(0, a_planes[0].shape[-1], K_STEP):
        for d in range(n):
            for i in (range(d, -1, -1) if descending else range(d + 1)):
                acc = acc + a_planes[i][..., k0:k0 + K_STEP] \
                    @ b_planes[d - i][..., k0:k0 + K_STEP, :]
    return acc


def causal_attention_split(q, k, v, bias, rate: float = 0.0,
                           seed: Optional[torch.Tensor] = None,
                           layer: int = 0, products: int = 6
                           ) -> torch.Tensor:
    """The float32 tensor-core body's forward arithmetic written plainly
    (csrc/causal_attention_fwd.cu): q . k^T and (p r) . v on bf16 planes
    (three, the kernel's six split products; two, three products, for
    comparison) in the kernel's order (:func:`kstep_products`), the bias
    added in float32 and the sum scaled by the float32 reciprocal of
    sqrt(dk), float32 softmax statistics; the keys go by the kernel's
    tiles (:func:`key_tile`) with a running max, the probabilities split
    as exp(s - running max) r, the output rescaled as the max moves before
    the tile's p . v is added onto it, and divided by the row sum at the
    end; past dk 256 q . k^T by quarters of dk (:func:`quarter_sum`).
    Float32 inputs, the output of :func:`causal_attention_ref`.  For
    tests and measurements only: the card runs the kernel."""
    N, S, dk = q.shape
    n = FWD_PLANES if products == 6 else BWD_PLANES
    dev = q.device
    inv_sqrt = torch.tensor(1.0, device=dev) / torch.sqrt(
        torch.tensor(float(dk), device=dev))
    qp = torch.stack(ffn.split_planes(q.float(), n))
    kt = torch.stack(ffn.split_planes(k.float(), n)).transpose(-1, -2)
    s = quarter_sum(lambda a, b: kstep_products(
        a, b, torch.zeros(N, S, S, device=dev)), qp, kt, dk)
    s = (s + bias.float()) * inv_sqrt
    causal = torch.ones(S, S, dtype=torch.bool, device=dev).tril()
    s = s.masked_fill(~causal, float("-inf"))
    mask = dropout.ar_attention_mask(seed, rate, layer, N, S, dev)
    vp = ffn.split_planes(v.float(), n)
    tile = key_tile(dk, n)
    m = torch.full((N, S, 1), float("-inf"), device=dev)
    l = torch.zeros(N, S, 1, device=dev)
    o = torch.zeros(N, S, dk, device=dev)
    for k0 in range(0, S, tile):      # key 0 <= every row: m finite after
        st = s[..., k0:k0 + tile]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        rescale = torch.exp(m - m_new)
        e = torch.exp(st - m_new)
        pd = e if mask is None else e * mask[..., k0:k0 + tile]
        l = l * rescale + e.sum(-1, keepdim=True)
        o = kstep_products(ffn.split_planes(pd, n),
                           [t[:, k0:k0 + tile] for t in vp], o * rescale,
                           descending=True)
        m = m_new
    return o * (1.0 / l)


def causal_attention_bwd_split(q, k, v, bias, dout, rate: float = 0.0,
                               seed: Optional[torch.Tensor] = None,
                               layer: int = 0, products: int = 3
                               ) -> Tuple[torch.Tensor, ...]:
    """The float32 tensor-core body's backward arithmetic written plainly
    (csrc/causal_attention_bwd.cu): :func:`causal_attention_bwd_ref` with
    q . k^T, do . v^T, (p r)^T . do, ds . k and ds^T . q each as
    ``products`` split products of bf16 planes, past dk 256 q . k^T and
    do . v^T by quarters of dk (:func:`quarter_sum`).  Float32 inputs;
    (dq, dk, dv, dbias).  For tests and measurements only."""
    N, S, dk = q.shape
    qf, kf, vf, do = q.float(), k.float(), v.float(), dout.float()

    def mm(a, b):
        return ffn.split_matmul(a, b, products)
    s = (quarter_sum(mm, qf, kf.transpose(-1, -2), dk)
         + bias.float()) / math.sqrt(dk)
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    mask = dropout.ar_attention_mask(seed, rate, layer, N, S, q.device)
    pd = p if mask is None else p * mask
    dp = quarter_sum(mm, do, vf.transpose(-1, -2), dk)
    if mask is not None:
        dp = dp * mask
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) / math.sqrt(dk)
    return (ffn.split_matmul(ds, kf, products),
            ffn.split_matmul(ds.transpose(-1, -2), qf, products),
            ffn.split_matmul(pd.transpose(-1, -2), do, products), ds)


# the longest S checked on the card (tests/test_torch_cuda.py,
# chip_smoke.py: --sizeWindow 655360); the kernels' memory and the dropout
# key i * S + j in 32 bits would take 46340
MAX_S = 4096
MAX_DK = 512          # the widest staged head: DKP 512


def supported(S: int, dk: int,
              dtype: torch.dtype = torch.bfloat16) -> Optional[str]:
    """Why the kernels refuse a sequence length S and head width dk in
    ``dtype``, or None: dk up to 512 (the body pads it to 32, 64, 128, 256
    or 512), in bf16 a multiple of 8 (bf16 rows are staged 16 bytes at a
    time; float32 ones are split into padded planes first); 0 < S <=
    4096, the longest checked on the card (the kernels hold no (S, S)
    tile: their scratch is the rows' statistics and, in float32, the
    operands' planes, O(N S dk))."""
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


def _scratch(n_bytes: int, device) -> Optional[torch.Tensor]:
    """A kernel's scratch of ``n_bytes`` (16-byte aligned), or None."""
    return torch.empty(n_bytes, dtype=torch.uint8,
                       device=device) if n_bytes else None


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
    code = _build.DTYPE_CODES[q.dtype]
    scratch = _scratch(lib.cpc_causal_attention_fwd_scratch(N, S, dk, code),
                       q.device)
    with torch.cuda.device(q.device):
        status = lib.cpc_causal_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(), _build.ptr(scratch), N, S, dk, layer,
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
    # the rows' statistics and, in float32, the operands' bf16 planes
    # (csrc/causal_attention_bwd.cu)
    scratch = _scratch(lib.cpc_causal_attention_bwd_scratch(
        N, S, dk, _build.DTYPE_CODES[q.dtype]), q.device)
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
