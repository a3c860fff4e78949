"""The causal transformer AR (cpc_audio_tpu/models/transformer.py:54-224).

``TransformerAR`` stacks post-LN layers ``LN(x + MHA(x))``, ``LN(y +
FFN(y))`` over the encoding ``(B, S, D)``; ``get_ar`` builds it with one
layer whatever ``nLevelsGRU`` says.  The parameter tree is the JAX
package's, with its names and its ``(in, out)`` kernel layout:
``layer{i}.multihead.{Wq,Wk,Wv,Wo}.kernel (D, D)``, ``multihead.Krelpos
(dk, size_seq)`` (absent under ``abspos``), ``ffnetwork.lin{1,2}.{kernel,
bias}`` and ``ln_multihead``/``ln_ffnetwork`` ``.{weight, bias}``.

The projections and the FFN are plain ``torch.matmul`` (the JAX package
leaves them to XLA too).  The attention runs in the K5 kernel
(ops/causal_attention.py) on a dense bias: the Shaw term built by the
zero-pad/reshape skew of ``q . Krelpos`` (transformer.py:91-94), or zeros
under ``abspos``, where the sinusoidal table is added to the input
instead.

In training the layers drop attention probabilities and FFN hidden units
at ``dropout`` (0.1, the JAX module's field, whatever ``config.dropout``
says), from the step's int64 seed tensor at the AR's own dropout sites
(ops/dropout.py), keyed on (layer, n, i * S + j) and (layer, row, f).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .._common import uniform
from ..ops import dropout
from ..ops.causal_attention import causal_attention


class Dense(nn.Module):
    """Linear layer, (in, out) kernel, torch init U(+-1/sqrt(in))."""

    def __init__(self, d_in: int, d_out: int, use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        bound = 1.0 / math.sqrt(d_in)
        self.kernel = uniform((d_in, d_out), bound, generator)
        self.bias = uniform((d_out,), bound, generator) if use_bias \
            else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x, self.kernel.to(x.dtype))
        return y if self.bias is None else y + self.bias.to(x.dtype)


class MultiHeadAttention(nn.Module):
    """Causal MHA with optional Shaw relative positions (transformer.py
    :54-133); Wq/Wk/Wv/Wo without bias."""

    def __init__(self, size_seq: int, dmodel: int, nheads: int = 8,
                 relpos: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.size_seq = size_seq
        self.nheads = nheads
        self.relpos = relpos
        for name in ("Wq", "Wk", "Wv"):
            setattr(self, name, Dense(dmodel, dmodel, False, generator))
        dk = dmodel // nheads
        if relpos:
            self.Krelpos = uniform((dk, size_seq), 1.0 / math.sqrt(dk),
                                   generator)
        self.Wo = Dense(dmodel, dmodel, False, generator)

    def forward(self, x: torch.Tensor, rate: float = 0.0,
                seed: Optional[torch.Tensor] = None,
                layer: int = 0) -> torch.Tensor:
        B, S, D = x.shape
        h = self.nheads
        dk = D // h

        def heads(t):                          # (B, S, D) -> (B, h, S, dk)
            return t.reshape(B, S, h, dk).transpose(1, 2)

        q, k, v = (heads(getattr(self, n)(x)) for n in ("Wq", "Wk", "Wv"))
        if self.relpos:
            if S != self.size_seq:
                raise ValueError(f"the rel-pos skew needs S == size_seq "
                                 f"({S} != {self.size_seq}), as the JAX "
                                 f"package's does")
            qp = torch.einsum("bhqd,dr->bhqr", q, self.Krelpos.to(x.dtype))
            qp = F.pad(qp, (1, 0))                         # (B, h, S, S+1)
            bias = qp.reshape(B, h, S + 1, S)[:, :, 1:]    # skew
        else:
            bias = x.new_zeros((B, h, S, S))

        def rows(t):
            return t.reshape(B * h, *t.shape[2:]).contiguous()

        y = causal_attention(rows(q), rows(k), rows(v), rows(bias), rate,
                             seed, layer)
        return self.Wo(y.reshape(B, h, S, dk).transpose(1, 2)
                       .reshape(B, S, D))


class FFNetwork(nn.Module):
    """Two-layer ReLU MLP (transformer.py:136-147)."""

    def __init__(self, dmodel: int, dff: int = 2048,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lin1 = Dense(dmodel, dff, True, generator)
        self.lin2 = Dense(dff, dmodel, True, generator)

    def forward(self, x: torch.Tensor, rate: float = 0.0,
                seed: Optional[torch.Tensor] = None,
                layer: int = 0) -> torch.Tensor:
        y = torch.relu(self.lin1(x))
        B, S, _ = x.shape
        y = dropout.dropout(y, seed, rate, dropout.SITE_AR_FFN,
                            offset=layer * B * S)
        return self.lin2(y)


class LayerNorm(nn.Module):
    """Post-LN layer norm, biased variance, eps 1e-5 (transformer.py
    :150-163); statistics in float32, output in the input dtype."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, correction=0)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)


class TransformerLayer(nn.Module):
    """Post-LN block: LN(x + MHA(x)), LN(y + FFN(y)) (transformer.py
    :166-184)."""

    def __init__(self, size_seq: int, dmodel: int, dff: int = 2048,
                 nheads: int = 8, abspos: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.multihead = MultiHeadAttention(size_seq, dmodel, nheads,
                                            not abspos, generator)
        self.ln_multihead = LayerNorm(dmodel)
        self.ffnetwork = FFNetwork(dmodel, dff, generator)
        self.ln_ffnetwork = LayerNorm(dmodel)

    def forward(self, x: torch.Tensor, rate: float = 0.0,
                seed: Optional[torch.Tensor] = None,
                layer: int = 0) -> torch.Tensor:
        y = self.ln_multihead(x + self.multihead(x, rate, seed, layer))
        return self.ln_ffnetwork(y + self.ffnetwork(y, rate, seed, layer))


def sinusoidal_positions(seqlen: int, dmodel: int) -> np.ndarray:
    """StaticPositionEmbedding table (transformer.py:187-195)."""
    pos = np.arange(seqlen, dtype=np.float64)[:, None] * np.ones((1, dmodel))
    dim = np.arange(dmodel, dtype=np.float64)[None, :] * np.ones((seqlen, 1))
    div = np.exp(-math.log(10000.0) * (2 * (dim // 2) / dmodel))
    pos = pos * div
    pos[:, 0::2] = np.sin(pos[:, 0::2])
    pos[:, 1::2] = np.cos(pos[:, 1::2])
    return pos.astype(np.float32)


class TransformerAR(nn.Module):
    """Stack of causal transformer layers (transformer.py:198-224) with
    the ``(x, hidden) -> (y, hidden)`` AR contract; the hidden state is
    passed through unused."""

    def __init__(self, dim_encoded: int, n_layers: int, size_seq: int,
                 abspos: bool = False, dropout: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dim_output = dim_encoded
        self.n_layers = n_layers
        self.abspos = abspos
        self.dropout = dropout
        for i in range(n_layers):
            setattr(self, f"layer{i}",
                    TransformerLayer(size_seq, dim_encoded, abspos=abspos,
                                     generator=generator))
        if abspos:
            self.register_buffer("positions", torch.from_numpy(
                sinusoidal_positions(size_seq, dim_encoded)),
                persistent=False)

    def zero_state(self, batch: int, dtype: torch.dtype,
                   device: torch.device) -> None:
        return None

    def forward(self, x: torch.Tensor, hidden=None, train: bool = False,
                seed: Optional[torch.Tensor] = None):
        """``train=True`` drops at ``self.dropout`` and needs ``seed``, an
        int64 tensor of shape (1,) on x's device."""
        rate = self.dropout if train else 0.0
        if self.abspos:
            x = x + self.positions[None, :x.shape[1]].to(x.dtype)
        for i in range(self.n_layers):
            x = getattr(self, f"layer{i}")(x, rate, seed, i)
        return x, hidden
