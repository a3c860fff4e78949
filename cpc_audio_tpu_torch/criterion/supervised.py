"""Supervised probes: speaker, phone and CTC-phone criteria
(cpc_audio_tpu/criterion/supervised.py:19-101).

Each is ``forward(c_feature, encoded_data, label, **unused) -> (loss (1,),
acc (1,))`` like the CPC criterion, which lets the train and validation
steps call any criterion alike; the CPC criterion's sampling and dropout
arguments are accepted and ignored.  The classifiers are ``Dense`` layers
((in, out) kernel and bias, the JAX package's layout and names); logits
are taken to float32 before the loss.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..models.transformer import Dense
from .seq_alignment import collapse_label_chain_padded


def _nll_and_accuracy(logits: torch.Tensor, label: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean negative log-likelihood of ``label`` under softmax(logits
    (N, P)) and the argmax accuracy, each of shape (1,)."""
    label = label.long()
    loss = F.cross_entropy(logits, label)
    acc = (logits.argmax(dim=1) == label).float().mean()
    return loss.reshape(1), acc.reshape(1)


class SpeakerCriterion(nn.Module):
    """Linear speaker classifier on the last context frame; ``label`` (B,)
    speaker ids."""

    def __init__(self, dim_encoder: int, n_speakers: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.linearSpeakerClassifier = Dense(dim_encoder, n_speakers,
                                             generator=generator)

    def forward(self, c_feature: torch.Tensor, encoded_data: torch.Tensor,
                label: torch.Tensor, **unused
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        logits = self.linearSpeakerClassifier(c_feature[:, -1, :]).float()
        return _nll_and_accuracy(logits, label)


class PhoneCriterion(nn.Module):
    """Frame-wise phone classifier of ``n_layers`` Dense layers, each of
    width ``n_phones``, with a ReLU between two; on the context, or on the
    encoding with ``on_encoder``.  ``label`` (B, S) frame-aligned phones."""

    def __init__(self, dim_encoder: int, n_phones: int,
                 on_encoder: bool = False, n_layers: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_phones = n_phones
        self.on_encoder = on_encoder
        self.n_layers = n_layers
        for l in range(n_layers):
            setattr(self, f"classifier{l}",
                    Dense(dim_encoder if l == 0 else n_phones, n_phones,
                          generator=generator))

    def get_prediction(self, c_feature: torch.Tensor) -> torch.Tensor:
        y = self.classifier0(c_feature)
        for l in range(1, self.n_layers):
            y = getattr(self, f"classifier{l}")(torch.relu(y))
        return y

    def forward(self, c_feature: torch.Tensor, encoded_data: torch.Tensor,
                label: torch.Tensor, **unused
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = encoded_data if self.on_encoder else c_feature
        logits = self.get_prediction(x).float().reshape(-1, self.n_phones)
        return _nll_and_accuracy(logits, label.reshape(-1))


class CTCPhoneCriterion(nn.Module):
    """A Dense layer to ``n_phones + 1`` classes and the CTC loss, blank =
    ``n_phones``.  ``label`` (B, T) frame-aligned phones, collapsed to
    their chains on the device.  The loss is torch's ``nn.CTCLoss(
    reduction='mean', zero_infinity=True)`` of the reference: each
    sequence's loss over its target length, then the batch mean, an
    infeasible sequence counting 0 (and no gradient).  The accuracy is 0."""

    def __init__(self, dim_encoder: int, n_phones: int,
                 on_encoder: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if on_encoder:
            raise ValueError("On encoder version not implemented yet")
        self.n_phones = n_phones
        self.PhoneCriterionClassifier = Dense(dim_encoder, n_phones + 1,
                                              generator=generator)

    def get_prediction(self, c_feature: torch.Tensor) -> torch.Tensor:
        return self.PhoneCriterionClassifier(c_feature)

    def forward(self, c_feature: torch.Tensor, encoded_data: torch.Tensor,
                label: torch.Tensor, **unused
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        B, S, _ = c_feature.shape
        logits = self.get_prediction(c_feature).float()       # (B, S, P+1)
        targets, paddings = collapse_label_chain_padded(label.long())
        sizes = (1.0 - paddings).sum(dim=1)
        log_probs = F.log_softmax(logits, dim=-1).transpose(0, 1)
        loss = F.ctc_loss(log_probs, targets, torch.full(
            (B,), S, dtype=torch.long, device=logits.device),
            sizes.long(), blank=self.n_phones, reduction="none",
            zero_infinity=True)
        loss = loss / sizes.clamp(min=1.0)
        loss = torch.where(torch.isfinite(loss), loss,
                           torch.zeros_like(loss))
        return loss.mean().reshape(1), logits.new_zeros(1)
