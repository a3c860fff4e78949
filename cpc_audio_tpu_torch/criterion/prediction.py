"""Multi-step prediction network (cpc_audio_tpu/criterion/prediction.py
:138-171), transformer heads only."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .._common import no_training
from .stacked_heads import StackedTransformerHeads


class PredictionNetwork(nn.Module):
    """K stacked prediction heads -> (K, B, W, dimEnc).  The prediction
    dropout of the JAX module (rate 0.5, ``dropout=True``) acts only in
    training, which the port does not run yet."""

    def __init__(self, n_predicts: int, dim_output_encoder: int,
                 rnn_mode: str = "transformer", size_input_seq: int = 116,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if rnn_mode != "transformer":
            raise NotImplementedError(
                f"rnnMode={rnn_mode!r} heads are not ported yet: ROADMAP "
                f"Queue 1 item 11 (non-default variants)")
        self.heads = StackedTransformerHeads(
            n_predicts, dim_output_encoder, size_input_seq,
            generator=generator)

    def forward(self, c: torch.Tensor, train: bool = False) -> torch.Tensor:
        no_training(train)
        return self.heads(c)
