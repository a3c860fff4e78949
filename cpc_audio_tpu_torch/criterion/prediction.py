"""Multi-step prediction network (cpc_audio_tpu/criterion/prediction.py
:138-171), transformer heads only."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops import dropout as drop
from .stacked_heads import StackedTransformerHeads


class PredictionNetwork(nn.Module):
    """K stacked prediction heads -> (K, B, W, dimEnc).  With
    ``dropout=True`` (``config.dropout``) the predictions are dropped at
    rate 0.5 in training, as the JAX module's ``nn.Dropout(0.5)``; the bits
    come from ``ops/dropout.py`` with the step's seed (site
    ``SITE_PREDICTION``)."""

    def __init__(self, n_predicts: int, dim_output_encoder: int,
                 rnn_mode: str = "transformer", size_input_seq: int = 116,
                 generator: Optional[torch.Generator] = None,
                 dropout: bool = False, attention_block: bool = False):
        super().__init__()
        self.dropout = dropout
        if rnn_mode != "transformer":
            raise NotImplementedError(
                f"rnnMode={rnn_mode!r} heads are not ported yet: ROADMAP "
                f"Queue 1 item 11 (non-default variants)")
        self.heads = StackedTransformerHeads(
            n_predicts, dim_output_encoder, size_input_seq,
            generator=generator, attention_block=attention_block)

    def forward(self, c: torch.Tensor, train: bool = False,
                seed: Optional[torch.Tensor] = None) -> torch.Tensor:
        preds = self.heads(c, train, seed)
        if train and self.dropout:
            preds = drop.dropout(preds, seed, 0.5, drop.SITE_PREDICTION)
        return preds
