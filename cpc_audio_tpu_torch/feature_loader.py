"""Feature extraction API of the port (cpc_audio_tpu/feature_loader.py
:202-350): ``FeatureModule``, ``seq_normalization`` and per-file
``build_feature``.  The lane-packed ``build_features_batched`` is ROADMAP
Queue 1 item 9."""

from __future__ import annotations

import numpy as np
import torch

from ._common import precision_policy
from .data.audio_io import decode_file


def seq_normalization(out: torch.Tensor) -> torch.Tensor:
    """Per-sequence time normalisation with the unbiased variance.  A
    1-frame sequence has no unbiased variance (the reference emits NaN):
    it returns zeros, as the JAX package does (docs/DESIGN.md)."""
    mean = out.mean(dim=1, keepdim=True)
    if out.shape[1] <= 1:
        return out - mean
    var = out.var(dim=1, keepdim=True, correction=1)
    return (out - mean) / torch.sqrt(var + 1e-8)


class FeatureModule:
    """Inference wrapper over a CPCModel (feature_loader.py:219-257).

    ``keep_hidden`` carries the LSTM state from one call to the next
    (``reset()`` clears it); ``get_encoded`` returns the encoder output z
    instead of the context c; ``collapse`` flattens (B, S, C) to
    (B*S, C).  Input goes to the model's device; output is float32 there."""

    def __init__(self, model: torch.nn.Module, get_encoded: bool = False,
                 collapse: bool = False, keep_hidden: bool = False):
        self.model = model
        self.get_encoded = get_encoded
        self.collapse = collapse
        self.keep_hidden = keep_hidden
        self.device = next(model.parameters()).device
        self.hidden = None

    def get_downsampling_factor(self) -> int:
        return 160

    def reset(self) -> None:
        self.hidden = None

    def __call__(self, data) -> torch.Tensor:
        batch = data[0] if isinstance(data, tuple) else data
        batch = torch.as_tensor(np.asarray(batch, np.float32)) \
            if not isinstance(batch, torch.Tensor) else batch.float()
        batch = batch.to(self.device)
        if batch.dim() == 2:
            batch = batch[:, None, :]
        with torch.inference_mode():
            c, z, _, h = self.model(batch, None, self.hidden)
        if self.keep_hidden:
            self.hidden = h
        features = z if self.get_encoded else c
        if self.collapse:
            features = features.reshape(-1, features.shape[-1])
        return features.float()


def build_feature(feature_maker, seq_path: str, strict: bool = False,
                  max_size_seq: int = 64000, seq_norm: bool = False,
                  pad_tail: bool = True) -> np.ndarray:
    """Chunked per-file inference (feature_loader.py:288-349), same chunking
    as the JAX package: non-strict right-pads the ragged tail to
    ``max_size_seq`` (unless ``pad_tail=False``) and keeps its valid
    frames; strict re-runs a full chunk ending at the file end and appends
    only the missing frames.  Returns (1, n_frames, C) float32."""
    precision_policy()
    seq = decode_file(seq_path)
    if hasattr(feature_maker, "reset"):
        feature_maker.reset()
    size_seq = len(seq)
    ds = feature_maker.get_downsampling_factor() \
        if hasattr(feature_maker, "get_downsampling_factor") else 160
    out = []
    start = 0
    while start < size_seq:
        if strict and start + max_size_seq > size_seq:
            break
        end = min(size_seq, start + max_size_seq)
        chunk = seq[start:end]
        valid_frames = len(chunk) // ds
        if len(chunk) < max_size_seq and pad_tail:
            chunk = np.pad(chunk, (0, max_size_seq - len(chunk)))
        features = feature_maker((chunk[None, None, :], None))
        features = features[:, :valid_frames]
        if seq_norm:
            features = seq_normalization(features)
        out.append(features)
        start += max_size_seq
    if strict and start < size_seq:
        chunk = seq[-max_size_seq:] if size_seq >= max_size_seq \
            else np.pad(seq, (max_size_seq - size_seq, 0))
        features = feature_maker((chunk[None, None, :], None))
        delta = (size_seq - start) // ds
        if seq_norm:
            features = seq_normalization(features)
        out.append(features[:, features.shape[1] - delta:])
    return torch.cat(out, dim=1).cpu().numpy()
