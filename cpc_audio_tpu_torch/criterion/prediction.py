"""Multi-step prediction network (cpc_audio_tpu/criterion/prediction.py):
K prediction heads of one ``--rnnMode``, all reading the same context
``c (B, W, din)`` and stacked on a leading K axis, ``(K, B, W, dout)``.

The parameters keep the JAX package's vmapped tree, a leading K axis on
every leaf under ``heads``:

* ``transformer``: one-layer causal transformers, ``heads.layer0.*``
  (``StackedTransformerHeads``: K2, K3, or K6);
* ``linear``: ``heads.kernel (K, din, dout)``, one product for all heads;
* ``ffd``: two equalized layers with a ReLU between them,
  ``heads.lin{1,2}.{kernel, bias}`` (criterion/custom_layers.py), the
  first one product for all heads, the second a K-batched one;
* ``conv4`` / ``conv8`` / ``conv12``: k - 1 zeros padded on the left in
  time, then an equalized conv of k taps, ``heads.module.{weight (K,
  dout, din, k), bias}``, one cuDNN conv to K * dout channels;
* ``RNN`` / ``LSTM``: one recurrent layer of width dout from zero state,
  ``heads.cell.{weight_ih (K, G dout, din), weight_hh (K, G dout, dout),
  bias_ih, bias_hh}`` in torch's per-head layout (the JAX tree stores
  the weights transposed, ``weight_*_t``; convert.py maps them).  The
  input projection of all K heads is one product; the LSTM heads'
  recurrence is K1 (``ops/lstm.lstm``) once per head, the RNN heads' a
  plain loop with one batched product a step for all heads (the JAX RNN
  is a ``lax.scan`` outside any kernel, models/ar.py:117-121).

Both recurrent heads are batch-first, the JAX package's documented
deviation from the reference, whose RNN head runs over the batch axis
(prediction.py:12-14).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .._common import uniform
from ..models.ar import MODES, _rnn_scan
from ..ops import dropout as drop
from ..ops.lstm import lstm
from .custom_layers import EqualizedConv1d, EqualizedDense
from .stacked_heads import StackedTransformerHeads

VALID_HEADS = ("transformer", "RNN", "LSTM", "linear", "ffd", "conv4",
               "conv8", "conv12")


def _flat(c: torch.Tensor) -> torch.Tensor:
    return c.reshape(-1, c.shape[-1])


class _LinearHeads(nn.Module):
    """``c . W`` per head (prediction.py:38-62), with the residual-style
    init where dout > din: the top (din, din) block N(0, 1), the rest
    N(0, 0.01^2); else U(-1/sqrt(din), 1/sqrt(din))."""

    def __init__(self, K: int, din: int, dout: int,
                 generator: Optional[torch.Generator]):
        super().__init__()
        if dout > din:
            top = torch.randn(K, din, din, generator=generator)
            bot = 0.01 * torch.randn(K, din, dout - din, generator=generator)
            self.kernel = nn.Parameter(torch.cat([top, bot], dim=2))
        else:
            self.kernel = uniform((K, din, dout), 1.0 / math.sqrt(din),
                                  generator)

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        return torch.einsum("mc,kcd->kmd", _flat(c),
                            self.kernel.to(c.dtype))


class _FFDHeads(nn.Module):
    """Two equalized layers with a ReLU between them (prediction.py
    :65-74)."""

    def __init__(self, K: int, din: int, dout: int,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.lin1 = EqualizedDense(K, din, dout, generator)
        self.lin2 = EqualizedDense(K, dout, dout, generator)

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        return self.lin2(torch.relu(self.lin1(_flat(c))))


class _ConvHeads(nn.Module):
    """The causal (left-padded) equalized conv head (prediction.py
    :77-90)."""

    def __init__(self, K: int, din: int, dout: int, kernel_size: int,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.kernel_size = kernel_size
        self.module = EqualizedConv1d(K, din, dout, kernel_size, generator)

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        x = F.pad(c.transpose(1, 2), (self.kernel_size - 1, 0))
        return self.module(x).transpose(2, 3)      # (K, B, W, dout)


class _StackedCell(nn.Module):
    """K recurrent layers' parameters, each in torch's nn.RNN / nn.LSTM
    layout, U(-1/sqrt(H), 1/sqrt(H)) as ar.py's ``_RecurrentLayer``."""

    def __init__(self, K: int, din: int, hidden: int, mode: str,
                 generator: Optional[torch.Generator]):
        super().__init__()
        G = MODES[mode] * hidden
        bound = 1.0 / math.sqrt(hidden)
        self.weight_ih = uniform((K, G, din), bound, generator)
        self.weight_hh = uniform((K, G, hidden), bound, generator)
        self.bias_ih = uniform((K, G), bound, generator)
        self.bias_hh = uniform((K, G), bound, generator)


class _RecurrentHeads(nn.Module):
    """One-layer RNN or LSTM heads of width dout from zero state
    (prediction.py:93-107)."""

    def __init__(self, K: int, din: int, dout: int, mode: str,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.mode, self.hidden = mode, dout
        self.cell = _StackedCell(K, din, dout, mode, generator)

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        B, W, _ = c.shape
        dt, cell = c.dtype, self.cell
        K = cell.weight_ih.shape[0]
        w_hh = cell.weight_hh.to(dt)
        if self.mode == "LSTM":
            # b_hh folds into the projection, as ar.py:88
            bias = cell.bias_ih.to(dt) + cell.bias_hh.to(dt)
        else:
            bias = cell.bias_ih.to(dt)
        x_proj = (torch.einsum("mc,kgc->kmg", _flat(c),
                               cell.weight_ih.to(dt))
                  + bias[:, None]).reshape(K, B, W, -1)
        h0 = c.new_zeros(B, self.hidden)
        if self.mode == "RNN":
            return _rnn_scan(x_proj, w_hh, cell.bias_hh.to(dt),
                             h0.expand(K, B, self.hidden))[0]
        w_hh = w_hh.contiguous()
        return torch.stack([lstm(x_proj[k].contiguous(), w_hh[k], h0, h0)[0]
                            for k in range(K)])


class PredictionNetwork(nn.Module):
    """K stacked prediction heads of ``rnn_mode`` -> (K, B, W, dimEnc),
    reading ``dim_input`` channels (default ``dim_output_encoder``; the
    context plus the speaker embedding).  With ``dropout=True``
    (``config.dropout``) the predictions are dropped at rate 0.5 in
    training, as the JAX module's ``nn.Dropout(0.5)``; the bits come from
    ``ops/dropout.py`` with the step's seed (site ``SITE_PREDICTION``)."""

    def __init__(self, n_predicts: int, dim_output_encoder: int,
                 rnn_mode: str = "transformer", size_input_seq: int = 116,
                 generator: Optional[torch.Generator] = None,
                 dropout: bool = False, attention_block: bool = False,
                 dim_input: Optional[int] = None):
        super().__init__()
        self.dropout = dropout
        self.rnn_mode = rnn_mode
        self.n_predicts = n_predicts
        K, dout = n_predicts, dim_output_encoder
        din = dim_output_encoder if dim_input is None else dim_input
        if rnn_mode == "transformer":
            self.heads = StackedTransformerHeads(
                K, dout, size_input_seq, generator=generator,
                attention_block=attention_block)
        elif rnn_mode in ("RNN", "LSTM"):
            self.heads = _RecurrentHeads(K, din, dout, rnn_mode, generator)
        elif rnn_mode == "ffd":
            self.heads = _FFDHeads(K, din, dout, generator)
        elif rnn_mode and rnn_mode.startswith("conv"):
            self.heads = _ConvHeads(K, din, dout, int(rnn_mode[4:]),
                                    generator)
        else:
            # any other value builds linear heads, as _make_head does
            self.heads = _LinearHeads(K, din, dout, generator)

    def forward(self, c: torch.Tensor, train: bool = False,
                seed: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, W, _ = c.shape
        if self.rnn_mode == "transformer":
            preds = self.heads(c, train, seed)
        else:
            preds = self.heads(c).reshape(self.n_predicts, B, W, -1)
        if train and self.dropout:
            preds = drop.dropout(preds, seed, 0.5, drop.SITE_PREDICTION)
        return preds
