"""K-stacked transformer prediction heads
(cpc_audio_tpu/criterion/stacked_heads.py).

K independent one-layer post-LN causal transformers with Shaw relative
positions, all applied to the same context ``c (B, S, D)``.  The parameter
tree is the JAX package's, with its shapes: ``multihead.{Wq,Wk,Wv,Wo}.kernel
(K, D, D)``, ``multihead.Krelpos (K, dk, size_seq)``,
``ffnetwork.lin1.{kernel (K, D, F), bias (K, F)}``,
``ffnetwork.lin2.{kernel (K, F, D), bias (K, D)}`` and
``ln_multihead``/``ln_ffnetwork`` ``.{weight, bias} (K, D)``.

Per forward: the q/k/v and Wo projections are K-batched matmuls (the JAX
package leaves them to XLA); attention runs in the K2 kernel
(ops/head_attention.py); the residual ``c + attn . Wo`` is added here; the
tail LN1 -> FFN -> residual -> LN2 runs in the K3 kernel (ops/ffn.py).
The backward runs the K2 and K3 backward kernels.  With
``attention_block`` (``CPC_ATTN_BLOCK=1`` through ``build_criterion``) the
projections, the attention, Wo and the residual run as one K6 kernel
(ops/attention_block.py) in each direction, as the JAX package's
whole-block path does; the parameters are the same.

In training the heads drop attention probabilities and FFN hidden units
at ``dropout`` (0.1, as the JAX module's field, whatever ``config.dropout``
says).  Both sites draw from one int64 seed tensor, kept apart by their
site constants in ``ops/dropout.py``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .._common import uniform
from ..ops.attention_block import attention_block, attention_block_supported
from ..ops.ffn import layer_tail
from ..ops.head_attention import relpos_attention


class _Kernel(nn.Module):
    def __init__(self, shape, bound: float,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.kernel = uniform(shape, bound, generator)


class _Linear(nn.Module):
    def __init__(self, K: int, d_in: int, d_out: int,
                 generator: Optional[torch.Generator]):
        super().__init__()
        bound = 1.0 / math.sqrt(d_in)
        self.kernel = uniform((K, d_in, d_out), bound, generator)
        self.bias = uniform((K, d_out), bound, generator)


class _StackedLN(nn.Module):
    def __init__(self, K: int, D: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(K, D))
        self.bias = nn.Parameter(torch.zeros(K, D))


class _StackedMHA(nn.Module):
    def __init__(self, K: int, D: int, size_seq: int, nheads: int,
                 generator: Optional[torch.Generator],
                 attention_block: bool = False):
        super().__init__()
        self.nheads = nheads
        self.size_seq = size_seq
        self.attention_block = attention_block
        bound = 1.0 / math.sqrt(D)
        for name in ("Wq", "Wk", "Wv", "Wo"):
            setattr(self, name, _Kernel((K, D, D), bound, generator))
        dk = D // nheads
        self.Krelpos = uniform((K, dk, size_seq), 1.0 / math.sqrt(dk),
                               generator)

    def krel_for(self, S: int, dtype: torch.dtype) -> torch.Tensor:
        """Krelpos for sequence length S (stacked_heads.py:107-119): a
        longer sequence left-pads with zeros (distances past size_seq
        contribute 0), a shorter one keeps the first S columns."""
        krel = self.Krelpos
        if S > self.size_seq:
            krel = F.pad(krel, (S - self.size_seq, 0))
        elif S < self.size_seq:
            krel = krel[:, :, :S]
        return krel.to(dtype).contiguous()

    def forward(self, c: torch.Tensor, rate: float = 0.0,
                seed: Optional[torch.Tensor] = None) -> torch.Tensor:
        """c (B, S, D) -> c + attention (K, B*S, D)."""
        B, S, D = c.shape
        dt = c.dtype
        c2 = c.reshape(B * S, D).contiguous()
        krel = self.krel_for(S, dt)
        if self.attention_block and attention_block_supported(
                S, self.nheads, D // self.nheads):
            return attention_block(
                c2, *(getattr(self, n).kernel.to(dt).contiguous()
                      for n in ("Wq", "Wk", "Wv", "Wo")),
                krel, B, self.nheads, rate, seed)
        q, k, v = (torch.matmul(c2, getattr(self, n).kernel.to(dt))
                   for n in ("Wq", "Wk", "Wv"))              # (K, M, D)
        y = relpos_attention(q, k, v, krel, B, self.nheads, rate, seed)
        return torch.matmul(y, self.Wo.kernel.to(dt)) + c2


class _Layer0(nn.Module):
    def __init__(self, K: int, D: int, size_seq: int, nheads: int,
                 dff: int, generator: Optional[torch.Generator],
                 attention_block: bool = False):
        super().__init__()
        self.multihead = _StackedMHA(K, D, size_seq, nheads, generator,
                                     attention_block)
        self.ln_multihead = _StackedLN(K, D)
        self.ffnetwork = nn.Module()
        self.ffnetwork.lin1 = _Linear(K, D, dff, generator)
        self.ffnetwork.lin2 = _Linear(K, dff, D, generator)
        self.ln_ffnetwork = _StackedLN(K, D)

    def forward(self, c: torch.Tensor, rate: float = 0.0,
                seed: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, S, D = c.shape
        dt = c.dtype
        x = self.multihead(c, rate, seed)                    # (K, M, D)
        lin1, lin2 = self.ffnetwork.lin1, self.ffnetwork.lin2
        out = layer_tail(x, self.ln_multihead.weight, self.ln_multihead.bias,
                         lin1.kernel.to(dt).contiguous(), lin1.bias,
                         lin2.kernel.to(dt).contiguous(), lin2.bias,
                         self.ln_ffnetwork.weight, self.ln_ffnetwork.bias,
                         rate, seed=seed)
        return out.reshape(-1, B, S, D)


class StackedTransformerHeads(nn.Module):
    """All K heads in one pass: ``c (B, S, D) -> (K, B, S, D)``.

    ``train=True`` applies dropout at ``self.dropout`` and needs ``seed``,
    an int64 tensor of shape (1,) on c's device."""

    def __init__(self, n_predicts: int, dmodel: int, size_seq: int,
                 nheads: int = 8, dff: int = 2048, dropout: float = 0.1,
                 generator: Optional[torch.Generator] = None,
                 attention_block: bool = False):
        super().__init__()
        self.dropout = dropout
        self.layer0 = _Layer0(n_predicts, dmodel, size_seq, nheads, dff,
                              generator, attention_block)

    def forward(self, c: torch.Tensor, train: bool = False,
                seed: Optional[torch.Tensor] = None) -> torch.Tensor:
        rate = self.dropout if train else 0.0
        return self.layer0(c, rate, seed)
