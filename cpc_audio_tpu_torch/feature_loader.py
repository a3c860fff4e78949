"""Checkpoint loading and the feature-extraction API of the port
(cpc_audio_tpu/feature_loader.py).

* ``load_model`` rebuilds the model of one checkpoint (or a
  ``ConcatenatedModel`` of several) in any of the three formats of
  ``checkpoint.load_checkpoint``; the weights live in the module, so it
  returns ``(model, hidden_gar, hidden_encoder)``, the module on the card
  unless the caller passes ``device``.
* ``load_state_into`` (from ``convert``, under the JAX package's name
  here too) loads a checkpoint into a trainer's ``TrainState`` (``--load``
  and resume).
* ``FeatureModule``, ``ModelPhoneCombined``, ``seq_normalization`` and the
  per-file ``build_feature``; ``build_features_batched`` packs several
  files side by side into lanes of one batch.
* ``load_supervised_criterion`` rebuilds a phone or CTC probe.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import checkpoint as ckpt
from . import convert
# the JAX package's name for it
from .convert import load_state_into  # noqa: F401
from ._common import precision_policy, resolve_device
from .config import CPCConfig
from .data.audio_io import decode_file
from .models import ConcatenatedModel, build_model


# ---------------------------------------------------------------------------
# Model loading
# ---------------------------------------------------------------------------

def _load_single(path: str) -> Tuple[CPCConfig, dict, dict]:
    """(config, raw args, checkpoint data) of one checkpoint file; the
    config comes from the sidecar beside it."""
    found = ckpt.get_checkpoint_data(os.path.dirname(path))
    if found is None:
        raise FileNotFoundError(f"No checkpoint data found for {path}")
    _, _, config, raw_args = found
    return config, raw_args, ckpt.load_checkpoint(path)


def load_model(path_checkpoints: Sequence[str], load_state_dict: bool = True,
               compute_dtype: Optional[str] = None, device=None
               ) -> Tuple[torch.nn.Module, int, int]:
    """Rebuild the model(s) of checkpoints (cpc_audio_tpu/feature_loader.py
    :54-135): ``(model, hidden_gar, hidden_encoder)``, the model in eval
    mode on ``device`` (default: the card, see ``resolve_device``).

    Several paths give a ``ConcatenatedModel``.  A probe checkpoint whose
    args name a ``load`` chain elsewhere is rebuilt from that chain, then
    takes its own weights.  no_ar and transformer force hiddenGar to
    hiddenEncoder.  ``compute_dtype`` overrides the saved activation dtype
    (the weights stay float32).  ``load_state_dict=False`` leaves the
    seeded initial weights."""
    device = resolve_device(device)
    models: List[torch.nn.Module] = []
    hidden_gar, hidden_encoder = 0, 0
    for path in path_checkpoints:
        config, raw_args, data = _load_single(path)
        if compute_dtype is not None:
            config = config.replace(compute_dtype=compute_dtype)
        chain = raw_args.get("load")
        if chain and (len(chain) > 1 or
                      os.path.dirname(os.path.abspath(chain[0]))
                      != os.path.dirname(os.path.abspath(path))):
            model, hg, he = load_model(chain, load_state_dict=False,
                                       compute_dtype=compute_dtype,
                                       device="cpu")
            if isinstance(model, ConcatenatedModel):
                raise NotImplementedError(
                    "nested concatenated checkpoints unsupported")
        else:
            model = build_model(config, torch.Generator().manual_seed(0))
            hg, he = model.config.hiddenGar, model.config.hiddenEncoder
        if load_state_dict:
            model.load_state_dict(convert.model_state_dict(data, config))
        models.append(model)
        hidden_gar += hg
        hidden_encoder += he
    model = models[0] if len(models) == 1 else ConcatenatedModel(models)
    return model.to(device).eval(), hidden_gar, hidden_encoder


def load_supervised_criterion(path_checkpoint: str, device=None
                              ) -> Tuple[torch.nn.Module, int]:
    """Rebuild and load a phone or CTC probe checkpoint
    (cpc_audio_tpu/feature_loader.py:521-546): ``(criterion, n_phones)``,
    the criterion in eval mode on ``device`` (default: the card)."""
    from .criterion import CTCPhoneCriterion, PhoneCriterion
    from .data import parse_seq_labels

    device = resolve_device(device)
    config, raw_args, data = _load_single(path_checkpoint)
    _, n_phones = parse_seq_labels(raw_args["pathPhone"])
    dim = config.hiddenGar if not config.onEncoder else config.hiddenEncoder
    if raw_args.get("CTC"):
        criterion = CTCPhoneCriterion(dim, n_phones, config.onEncoder)
    else:
        criterion = PhoneCriterion(dim, n_phones, config.onEncoder,
                                   n_layers=config.nLevelsPhone)
    criterion.load_state_dict(convert.criterion_state_dict(
        data, config, kind="ctc" if raw_args.get("CTC") else "phone"))
    return criterion.to(device).eval(), n_phones


# ---------------------------------------------------------------------------
# Feature extraction
# ---------------------------------------------------------------------------

def seq_normalization(out: torch.Tensor) -> torch.Tensor:
    """Per-sequence time normalisation with the unbiased variance.  A
    1-frame sequence has no unbiased variance (the reference emits NaN):
    it returns zeros, as the JAX package does (docs/DESIGN.md)."""
    mean = out.mean(dim=1, keepdim=True)
    if out.shape[1] <= 1:
        return out - mean
    var = out.var(dim=1, keepdim=True, correction=1)
    return (out - mean) / torch.sqrt(var + 1e-8)


def to_one_hot(labels: torch.Tensor, n_items: int) -> torch.Tensor:
    """(B, S) integer labels -> (B, S, n_items) float32 one-hot."""
    return F.one_hot(labels.long(), n_items).float()


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


class ModelPhoneCombined:
    """A feature maker followed by a phone classifier: per-frame phone
    posteriors (softmax), or their argmax one-hot with ``one_hot``
    (cpc_audio_tpu/feature_loader.py:260-285)."""

    def __init__(self, feature_module: FeatureModule,
                 criterion: torch.nn.Module, one_hot: bool = False):
        self.model = feature_module
        self.criterion = criterion
        self.one_hot = one_hot

    def get_downsampling_factor(self) -> int:
        return self.model.get_downsampling_factor()

    def __call__(self, data) -> torch.Tensor:
        c = self.model(data)
        with torch.inference_mode():
            pred = self.criterion.get_prediction(c).float()
        if self.one_hot:
            return to_one_hot(pred.argmax(dim=2), pred.shape[2])
        return torch.softmax(pred, dim=2)


def _start_copy(features: torch.Tensor):
    """Start copying ``features`` to the host: on the card a non-blocking
    copy into pinned memory, with an event that marks its end; on the CPU
    the tensor itself.  :func:`_host` waits for it."""
    if features.device.type != "cuda":
        return features, None
    host = torch.empty(features.shape, dtype=features.dtype,
                       pin_memory=True)
    host.copy_(features, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def _host(copy) -> np.ndarray:
    host, event = copy
    if event is not None:
        event.synchronize()
    return host.numpy()


def build_feature(feature_maker, seq_path: str, strict: bool = False,
                  max_size_seq: int = 64000, seq_norm: bool = False,
                  pad_tail: bool = True) -> np.ndarray:
    """Chunked per-file inference (feature_loader.py:288-349), same chunking
    as the JAX package: non-strict right-pads the ragged tail to
    ``max_size_seq`` (unless ``pad_tail=False``) and keeps its valid
    frames; strict re-runs a full chunk ending at the file end and appends
    only the missing frames.  Each chunk's frames leave the device as the
    chunk completes (a non-blocking copy on the card), so the device holds
    one chunk's output at a time.  Returns (1, n_frames, C) float32."""
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
        out.append(_start_copy(features))
        start += max_size_seq
    if strict and start < size_seq:
        chunk = seq[-max_size_seq:] if size_seq >= max_size_seq \
            else np.pad(seq, (max_size_seq - size_seq, 0))
        features = feature_maker((chunk[None, None, :], None))
        delta = (size_seq - start) // ds
        if seq_norm:
            features = seq_normalization(features)
        out.append(_start_copy(features[:, features.shape[1] - delta:]))
    return np.concatenate([_host(c) for c in out], axis=1)


def _scale_hidden(hidden, keep: torch.Tensor):
    """Each lane's carried state times its ``keep`` (0 or 1): a tensor
    (layers, lanes, H), an (h, c) pair or a list of them, or None."""
    if hidden is None:
        return None
    if isinstance(hidden, torch.Tensor):
        return hidden * keep[:, None].to(hidden.dtype)
    return type(hidden)(_scale_hidden(h, keep) for h in hidden)


def build_features_batched(feature_maker: FeatureModule,
                           seq_paths: Sequence[str], n_lanes: int = 8,
                           max_size_seq: int = 64000,
                           seq_norm: bool = False,
                           decode_workers: int = 4
                           ) -> Iterator[Tuple[int, np.ndarray]]:
    """Batched multi-file feature extraction
    (cpc_audio_tpu/feature_loader.py:352-518).

    Packs ``n_lanes`` files side by side into ``(n_lanes, 1,
    max_size_seq)`` batches, one forward a batch of chunks, keeping the
    per-file semantics of :func:`build_feature` (non-strict, tail padded):

    * a file's chunks stay in one lane, in order, so the recurrent state
      carries across them when the module has ``keep_hidden``; the carried
      state is multiplied by each lane's ``keep``, 0 at a file's first
      chunk and on a dead lane, so it never leaks between files;
    * the tail chunk is zero-padded and only its valid frames kept;
    * ``seq_norm`` applies per chunk over its valid frames.

    Lanes that run out of files take zeros and their output is dropped.
    Decoding runs ahead on a thread pool.  One-deep pipeline: batch t + 1
    is dispatched before batch t is read back, through a non-blocking copy
    into pinned host memory and an event on the card.

    Yields ``(index, features (1, n_frames, C) float32)`` in the order
    files complete (not input order); ``index`` is the position in
    ``seq_paths``."""
    precision_policy()
    model = feature_maker.model
    device = feature_maker.device
    get_encoded = feature_maker.get_encoded
    carry_hidden = feature_maker.keep_hidden
    ds = feature_maker.get_downsampling_factor()
    hidden = model.zero_state(n_lanes, device) \
        if hasattr(model, "zero_state") else None

    n_total = len(seq_paths)
    pool = ThreadPoolExecutor(max_workers=decode_workers)
    try:
        pending = [(i, pool.submit(decode_file, p))
                   for i, p in enumerate(seq_paths[:2 * n_lanes])]
        next_submit = len(pending)
        # per lane: [file index, waveform, sample cursor] or None; frames
        # of unfinished files gather in acc, at read-back time
        lanes: List[Any] = [None] * n_lanes
        acc: dict = {}

        def refill(lane: int) -> bool:
            nonlocal next_submit
            if not pending:
                return False
            idx, fut = pending.pop(0)
            if next_submit < n_total:
                pending.append((next_submit, pool.submit(
                    decode_file, seq_paths[next_submit])))
                next_submit += 1
            lanes[lane] = [idx, np.asarray(fut.result(), np.float32), 0]
            acc[idx] = []
            return True

        def dispatch():
            """Pack and launch the next batch of chunks: (host copy, meta)
            or None when no work is left; meta rows (lane, file index,
            valid frames, last chunk of its file)."""
            nonlocal hidden
            batch = np.zeros((n_lanes, 1, max_size_seq), np.float32)
            keep = np.ones((n_lanes,), np.float32)
            meta = []
            for lane in range(n_lanes):
                if lanes[lane] is None and refill(lane):
                    keep[lane] = 0.0
                st = lanes[lane]
                if st is None:
                    keep[lane] = 0.0    # dead lane: zeros in, output dropped
                    continue
                if st[2] == 0:
                    keep[lane] = 0.0    # first chunk of a file
                chunk = st[1][st[2]:st[2] + max_size_seq]
                batch[lane, 0, :len(chunk)] = chunk
                last = st[2] + max_size_seq >= len(st[1])
                meta.append((lane, st[0], len(chunk) // ds, last))
                st[2] += max_size_seq
                if last:
                    lanes[lane] = None  # free for the next dispatch
            if not meta:
                return None
            if not carry_hidden:
                keep[:] = 0.0
            x = torch.from_numpy(batch)
            if device.type == "cuda":
                x = x.pin_memory()
            x = x.to(device, non_blocking=True)
            keep_t = torch.from_numpy(keep).to(device, non_blocking=True)
            with torch.inference_mode():
                c, z, _, hidden = model(x, None,
                                        _scale_hidden(hidden, keep_t))
                feats = (z if get_encoded else c).float()
            return _start_copy(feats), meta

        def drain(copy, meta):
            feats = _host(copy)          # one read-back a batch of chunks
            for lane, idx, valid, last in meta:
                f = feats[lane:lane + 1, :valid]
                # the per-file path's function, on the host
                if seq_norm:
                    f = seq_normalization(torch.from_numpy(f)).numpy()
                acc[idx].append(f)
                if last:
                    parts = acc.pop(idx)
                    yield idx, np.ascontiguousarray(
                        np.concatenate(parts, axis=1))

        inflight = dispatch()
        while inflight is not None:
            nxt = dispatch()
            yield from drain(*inflight)
            inflight = nxt
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
