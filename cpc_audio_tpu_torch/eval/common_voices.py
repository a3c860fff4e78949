"""Cross-lingual phone transfer on Common Voice: CTC training and PER, on
the port (cpc_audio_tpu/eval/common_voices.py).

Utterances are padded to the dataset's longest (one shape a dataset, as
the JAX package pads them).  The CTC classifier keeps the reference's
architecture: an optional masked per-utterance seqNorm, an optional
one-layer LSTM (K1, ``ops/lstm.lstm``), dropout 0.5, and
Conv1d(dim -> n_phones + 1, k, stride k // 2) without padding.  ``train``
fine-tunes the model with it (K1 forward and backward at T = the longest
utterance / 160) unless ``--freeze``, which runs the model under
``no_grad``; the best validation loss writes ``checkpoint.pt`` in the
port's format.  ``per`` computes softmax posteriors on the card, reads
them back through pinned memory and runs the beam search (20 kept) and
the PER on one persistent ``spawn`` process pool, one batch behind the
card.  The model runs on the card (``main(argv, device="cpu")`` on the
CPU).

Usage:
    python -m cpc_audio_tpu_torch.eval.common_voices train DB PHONES CKPT
    python -m cpc_audio_tpu_torch.eval.common_voices per OUTPUT_DIR
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import multiprocessing
import os
import pickle
import random
import sys
from concurrent.futures import ProcessPoolExecutor
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import checkpoint as ckpt
from .. import convert
from .._common import precision_policy, resolve_device, uniform
from ..criterion.seq_alignment import beam_search, get_seq_per
from ..data import filter_seqs, find_all_seqs, parse_seq_labels
from ..data.audio_io import decode_file
from ..feature_loader import _host, _start_copy, load_model
from ..models.ar import _RecurrentLayer
from ..ops import dropout
from ..parallel.train_step import (TrainState, _to_device,
                                   create_train_state, epoch_key,
                                   step_streams)

# beams the PER's search keeps, as the reference
N_KEEP = 20


class SingleSequenceDataset:
    """One item = one whole utterance, padded to the dataset's longest,
    and its phones, padded to the longest phone sequence."""

    def __init__(self, path_db: str, seq_names, phone_labels_dict: dict,
                 in_dim: int = 1):
        self.in_dim = in_dim
        self.seqs: List[np.ndarray] = []
        self.phones: List[np.ndarray] = []
        loaded = []
        for _, rel in seq_names:
            name = os.path.splitext(os.path.basename(rel))[0]
            if name not in phone_labels_dict:
                continue
            loaded.append((name, os.path.join(path_db, rel)))
        loaded.sort()
        self.max_size = 0
        self.max_size_phone = 0
        for name, path in loaded:
            seq = decode_file(path)
            labels = np.asarray(phone_labels_dict[name], np.int64)
            self.seqs.append(seq)
            self.phones.append(labels)
            self.max_size = max(self.max_size, len(seq))
            self.max_size_phone = max(self.max_size_phone, len(labels))
        print(f"Loaded {len(self.seqs)} sequences "
              f"(maxSizeSeq={self.max_size}, "
              f"maxSizePhone={self.max_size_phone})")

    def __len__(self):
        return len(self.seqs)

    def batches(self, batch_size: int, shuffle: bool = True,
                rng: Optional[random.Random] = None, pad_batch: bool = True):
        """Yield (seq (B, 1, maxS), size_seq (B,), phone (B, maxP),
        size_phone (B,)) at a fixed batch size (the tail re-samples)."""
        order = list(range(len(self.seqs)))
        if shuffle:
            (rng or random).shuffle(order)
        for i in range(0, len(order), batch_size):
            idx = order[i:i + batch_size]
            if pad_batch and len(idx) < batch_size:
                idx = idx + order[:batch_size - len(idx)]
            B = len(idx)
            seq = np.zeros((B, 1, self.max_size), np.float32)
            phone = np.zeros((B, self.max_size_phone), np.int64)
            size_seq = np.zeros(B, np.int64)
            size_phone = np.zeros(B, np.int64)
            for j, k in enumerate(idx):
                s, p = self.seqs[k], self.phones[k]
                seq[j, 0, :len(s)] = s
                phone[j, :len(p)] = p
                size_seq[j] = len(s)
                size_phone[j] = len(p)
            yield seq, size_seq, phone, size_phone


class Conv1d(nn.Module):
    """Strided channels-last 1-D convolution without padding, its kernel
    kept in the JAX package's (W, in, out) layout under its name
    (``models/encoder.Conv1d`` there), torch's init."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int, stride: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        bound = 1.0 / math.sqrt(c_in * kernel_size)
        self.stride = stride
        self.kernel = uniform((kernel_size, c_in, c_out), bound, generator)
        self.bias = uniform((c_out,), bound, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.kernel.to(x.dtype).permute(2, 1, 0)          # (out, in, W)
        y = F.conv1d(x.transpose(1, 2), w, self.bias.to(x.dtype),
                     stride=self.stride)
        return y.transpose(1, 2)


class CTCPhoneCriterionCV(nn.Module):
    """The Common Voice CTC head: ``forward(c_feature (B, S, H),
    feature_size (B,), label (B, P), label_size (B,), train, seed)`` -> the
    CTC loss (blank = ``n_phones``; ``mean``: each utterance's over its
    label count, then the batch mean; ``sum``), an infeasible utterance
    counting 0 (``zero_infinity``, as the reference's nn.CTCLoss)."""

    def __init__(self, dim_encoder: int, n_phones: int,
                 use_lstm: bool = False, size_kernel: int = 8,
                 seq_norm: bool = False, dropout: bool = False,
                 reduction: str = "mean",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dim_encoder = dim_encoder
        self.n_phones = n_phones
        self.use_lstm = use_lstm
        self.seq_norm = seq_norm
        self.dropout = dropout
        self.reduction = reduction
        if use_lstm:
            self.conv1 = _RecurrentLayer(dim_encoder, dim_encoder, "LSTM",
                                         generator)
        self.PhoneCriterionClassifier = Conv1d(
            dim_encoder, n_phones + 1, size_kernel, size_kernel // 2,
            generator)

    @property
    def blank_label(self) -> int:
        return self.n_phones

    def get_prediction(self, c_feature: torch.Tensor,
                       feature_size: torch.Tensor, train: bool = False,
                       seed: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, S, _ = c_feature.shape
        if self.seq_norm:
            mask = (torch.arange(S, device=c_feature.device)[None, :]
                    < feature_size[:, None])[..., None].to(c_feature.dtype)
            denom = feature_size.clamp(min=1)[:, None, None].to(
                c_feature.dtype)
            m = (c_feature * mask).sum(1, keepdim=True) / denom
            v = (((c_feature - m) * mask) ** 2).sum(1, keepdim=True) / denom
            c_feature = (c_feature - m) / torch.sqrt(v + 1e-8)
        if self.use_lstm:
            h0 = c_feature.new_zeros((B, self.dim_encoder))
            c_feature, _ = self.conv1(c_feature, (h0, h0))
        if self.dropout and train:
            c_feature = dropout.dropout(c_feature, seed, 0.5)
        return self.PhoneCriterionClassifier(c_feature)

    def forward(self, c_feature, feature_size, label, label_size,
                train: bool = False, seed: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        predictions = self.get_prediction(c_feature, feature_size, train,
                                          seed).float()
        B, S, _ = predictions.shape
        feature_size = torch.clamp(feature_size // 4, max=S)
        log_probs = F.log_softmax(predictions, dim=-1).transpose(0, 1)
        loss = F.ctc_loss(log_probs, label.long(), feature_size.long(),
                          label_size.long(), blank=self.n_phones,
                          reduction="none", zero_infinity=True)
        if self.reduction == "mean":
            return (loss / label_size.clamp(min=1)).mean()
        return loss.sum()


class IDModule(nn.Module):
    """Pre-computed features, ``pathCheckpoint`` ID: the batch (B, C, S)
    is the context, channels-last."""

    def forward(self, batch, label=None, hidden=None, train=False,
                seed=None):
        c = batch.transpose(1, 2)
        return c, c, label, None


def _features(state: TrainState, batch, size_seq, downsampling: int):
    c, _, _, _ = state.model(batch, None, None, train=False)
    return c, size_seq // downsampling


def make_train_step(state: TrainState, device, frozen: bool,
                    downsampling: int) -> Callable:
    """``step(seq, size_seq, phone, size_phone, key=None) -> loss`` (a
    device scalar, no host sync): forward (the model in eval mode, under
    ``no_grad`` when ``frozen``), the loss's backward and an Adam step;
    the criterion's dropout seed from (``key``, ``state.step``)."""
    precision_policy()
    device = torch.device(device)

    def step(seq, size_seq, phone, size_phone, key=None) -> torch.Tensor:
        seq = _to_device(seq, device)
        size_seq, phone, size_phone = (_to_device(t, device, torch.int64)
                                       for t in (size_seq, phone, size_phone))
        if key is None:
            key = torch.zeros(1, dtype=torch.int64, device=device)
        seed = step_streams(key, state.step)[0]
        state.optimizer.zero_grad(set_to_none=True)
        state.model.eval()
        state.criterion.train()
        with torch.no_grad() if frozen else contextlib.nullcontext():
            c, fsize = _features(state, seq, size_seq, downsampling)
        loss = state.criterion(c, fsize, phone, size_phone, train=True,
                               seed=seed)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return loss.detach()

    return step


def make_eval_steps(state: TrainState, device, downsampling: int
                    ) -> Tuple[Callable, Callable]:
    """(``val_step(seq, size_seq, phone, size_phone) -> loss``,
    ``predict_step(seq, size_seq) -> softmax posteriors (B, S', P + 1)``),
    both under ``inference_mode``, device tensors out."""
    precision_policy()
    device = torch.device(device)

    def val_step(seq, size_seq, phone, size_phone) -> torch.Tensor:
        seq = _to_device(seq, device)
        size_seq, phone, size_phone = (_to_device(t, device, torch.int64)
                                       for t in (size_seq, phone, size_phone))
        state.model.eval()
        state.criterion.eval()
        with torch.inference_mode():
            c, fsize = _features(state, seq, size_seq, downsampling)
            return state.criterion(c, fsize, phone, size_phone)

    def predict_step(seq, size_seq) -> torch.Tensor:
        seq = _to_device(seq, device)
        size_seq = _to_device(size_seq, device, torch.int64)
        state.model.eval()
        state.criterion.eval()
        with torch.inference_mode():
            c, fsize = _features(state, seq, size_seq, downsampling)
            pred = state.criterion.get_prediction(c, fsize)
            return torch.softmax(pred.float(), dim=2)

    return val_step, predict_step


def _per_one(args):
    posterior, valid, gt, blank = args
    pred_seq = beam_search(posterior[:valid], N_KEEP, blank)[0][1]
    return get_seq_per(gt, pred_seq)


def per_step(dataset: SingleSequenceDataset, predict_step,
             batch_size: int, downsampling: int,
             blank_label: int) -> Tuple[float, float]:
    """Beam-search PER over ``dataset``: (mean, standard deviation).

    One persistent ``spawn`` pool (a process holding a CUDA context is
    not forked) for the whole dataset, and a one-deep pipeline: batch
    N + 1's posteriors are computed and copied towards the host while
    batch N's beam searches run."""
    if len(dataset) == 0:
        raise ValueError("per: the dataset holds no utterance with phone "
                         "labels; check --pathDB, --pathVal and "
                         "--pathPhone")
    avg, var, n = 0.0, 0.0, 0
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=min(8, max(batch_size, 1)),
                             mp_context=ctx) as ex:

        def drain(copy, size_seq, phone, size_phone):
            nonlocal avg, var, n
            posts = _host(copy)
            jobs = []
            for b in range(len(size_seq)):
                valid = int(min(size_seq[b] // downsampling // 4,
                                posts.shape[1]))
                gt = phone[b, :size_phone[b]].tolist()
                jobs.append((posts[b], valid, gt, blank_label))
            values = list(ex.map(_per_one, jobs))
            avg += float(np.sum(values))
            var += float(np.sum(np.square(values)))
            n += len(values)

        pending = None
        for seq, size_seq, phone, size_phone in dataset.batches(
                batch_size, shuffle=False, pad_batch=False):
            copy = _start_copy(predict_step(seq, size_seq))
            if pending is not None:
                drain(*pending)
            pending = (copy, size_seq, phone, size_phone)
        if pending is not None:
            drain(*pending)
    avg /= n
    var = var / n - avg ** 2
    print(f"Average PER {avg}")
    print(f"Standard deviation PER {math.sqrt(max(var, 0.0))}")
    return avg, math.sqrt(max(var, 0.0))


def _cpu_state(module: nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True)
            for k, v in module.state_dict().items()}


def save_cv_checkpoint(path: str, state: TrainState, best_loss: float
                       ) -> None:
    """The port's ``checkpoint.pt``: the classifier's and the model's
    state dicts and the best validation loss, written atomically."""
    data = {"format": ckpt.FORMAT, "version": 1,
            "classifier": _cpu_state(state.criterion),
            "model": _cpu_state(state.model), "bestLoss": best_loss}
    torch.save(data, path + ".tmp")
    os.replace(path + ".tmp", path)


def load_cv_checkpoint(path: str) -> Tuple[dict, dict, Optional[float]]:
    """(model state dict, classifier state dict, best loss) of a
    ``checkpoint.pt`` of the port, or of the JAX package (its pickle of
    numpy trees, read without JAX by ``checkpoint._JaxFreeUnpickler`` and
    relaid by ``convert``'s ``_JAX`` table)."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:4] == b"PK\x03\x04":
        data = torch.load(io.BytesIO(raw), map_location="cpu",
                          weights_only=True)
        if data.get("format") != ckpt.FORMAT:
            raise ValueError(f"{path}: not a Common Voice checkpoint of "
                             f"the port")
        return data["model"], data["classifier"], data.get("bestLoss")
    try:
        data = ckpt._JaxFreeUnpickler(io.BytesIO(raw)).load()
    except pickle.UnpicklingError as e:
        raise ValueError(f"{path}: not a Common Voice checkpoint: {e}") \
            from e
    if not isinstance(data, dict) or data.get("format") != ckpt.JAX_FORMAT \
            or "classifier" not in data:
        raise ValueError(f"{path}: neither the port's nor the JAX "
                         f"package's Common Voice checkpoint")
    flat = convert.params_from_jax({"model": data["model"],
                                    "criterion": data["classifier"]})
    return (convert._strip(flat, "model."), convert._strip(flat,
                                                          "criterion."),
            data.get("bestLoss"))


def run_training(train_dataset, val_dataset, train_step, val_step, state,
                 batch_size: int, n_epochs: int, path_checkpoint: str,
                 seed: int = 0) -> float:
    """The epoch loop: losses summed on the device, read back once an
    epoch; the best validation loss writes ``path_checkpoint``."""
    best_loss = float("inf")
    rng = random.Random(seed)
    device = state.lr.device
    for epoch in range(n_epochs):
        key = epoch_key(seed, epoch, device)
        tot, n = None, 0
        for seq, ss, ph, sp in train_dataset.batches(batch_size, True, rng):
            loss = train_step(seq, ss, ph, sp, key)
            tot = loss if tot is None else tot + loss
            n += 1
        tot = float(tot) if tot is not None else 0.0
        print(f"Epoch {epoch} loss train : {tot / max(n, 1)}")
        tot, n = None, 0
        for seq, ss, ph, sp in val_dataset.batches(batch_size, False):
            loss = val_step(seq, ss, ph, sp)
            tot = loss if tot is None else tot + loss
            n += 1
        tot = float(tot) if tot is not None else 0.0
        loss_val = tot / max(n, 1)
        print(f"Epoch {epoch} loss val : {loss_val}")
        if loss_val < best_loss:
            best_loss = loss_val
            save_cv_checkpoint(path_checkpoint, state, best_loss)
    return best_loss


def build_parser():
    parser = argparse.ArgumentParser(
        description="Simple phone recognition pipeline for Common Voice")
    subparsers = parser.add_subparsers(dest="command")
    p = subparsers.add_parser("train")
    p.add_argument("pathDB", type=str)
    p.add_argument("pathPhone", type=str)
    p.add_argument("pathCheckpoint", type=str,
                   help="CPC checkpoint, or ID for pre-computed features")
    p.add_argument("--freeze", action="store_true")
    p.add_argument("--pathTrain", default=None, type=str)
    p.add_argument("--pathVal", default=None, type=str)
    p.add_argument("--file_extension", type=str, default=".mp3")
    p.add_argument("--batchSize", type=int, default=8)
    p.add_argument("--nEpochs", type=int, default=30)
    p.add_argument("--beta1", type=float, default=0.9)
    p.add_argument("--beta2", type=float, default=0.999)
    p.add_argument("--epsilon", type=float, default=1e-8)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("-o", "--output", type=str, default="out")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--no_pretraining", action="store_true")
    p.add_argument("--LSTM", action="store_true")
    p.add_argument("--seqNorm", action="store_true")
    p.add_argument("--kernelSize", type=int, default=8)
    p.add_argument("--dropout", action="store_true")
    p.add_argument("--in_dim", type=int, default=1)
    p.add_argument("--loss_reduction", type=str, default="mean",
                   choices=["mean", "sum"])
    p.add_argument("--seed", type=int, default=0)

    p = subparsers.add_parser("per")
    p.add_argument("output", type=str)
    p.add_argument("--batchSize", type=int, default=8)
    p.add_argument("--debug", action="store_true")
    p.add_argument("--pathDB", type=str, default=None)
    p.add_argument("--pathVal", type=str, default=None)
    p.add_argument("--pathPhone", type=str, default=None)
    p.add_argument("--file_extension", type=str, default=".mp3")
    p.add_argument("--name", type=str, default="0")
    p.add_argument("--seed", type=int, default=0)
    return parser


def get_per_args(args):
    """The training run's args for ``per`` (args_training.json)."""
    with open(os.path.join(args.output, "args_training.json")) as f:
        data = json.load(f)
    if args.pathDB is None:
        args.pathDB = data["pathDB"]
        args.file_extension = data["file_extension"]
    if args.pathVal is None and args.pathPhone is None:
        args.pathPhone = data["pathPhone"]
        args.pathVal = data["pathVal"]
    args.pathCheckpoint = data["pathCheckpoint"]
    args.no_pretraining = data["no_pretraining"]
    args.LSTM = data.get("LSTM", False)
    args.seqNorm = data.get("seqNorm", False)
    args.dropout = data.get("dropout", False)
    args.in_dim = data.get("in_dim", 1)
    args.loss_reduction = data.get("loss_reduction", "mean")
    args.kernelSize = data.get("kernelSize", 8)
    return args


def main(argv=None, device=None) -> int:
    """Run ``train`` or ``per`` on ``argv``, the model on ``device``
    (default: the card; raises without one)."""
    args = build_parser().parse_args(argv if argv is not None
                                     else sys.argv[1:])
    if args.command == "per":
        args = get_per_args(args)
    elif args.command != "train":
        build_parser().print_usage()
        return 2
    device = resolve_device(device)
    precision_policy()

    os.makedirs(args.output, exist_ok=True)
    phone_labels, n_phones = parse_seq_labels(args.pathPhone)
    in_seqs, _ = find_all_seqs(args.pathDB, extension=args.file_extension)
    if args.command == "train" and args.pathTrain is not None:
        seq_train = filter_seqs(args.pathTrain, in_seqs)
    else:
        seq_train = in_seqs
    if args.pathVal is None and args.command == "train":
        rng = random.Random(args.seed)
        seq_train = list(seq_train)
        rng.shuffle(seq_train)
        size_train = int(0.9 * len(seq_train))
        seq_train, seq_val = seq_train[:size_train], seq_train[size_train:]
    elif args.pathVal is not None:
        seq_val = filter_seqs(args.pathVal, in_seqs)
    else:
        raise RuntimeError("No validation dataset found for PER computation")
    if args.debug:
        seq_val = seq_val[:100]

    downsampling = 160
    if args.pathCheckpoint == "ID":
        downsampling = 1
        model, hidden_gar = IDModule(), args.in_dim
    else:
        model, hidden_gar, _ = load_model(
            [args.pathCheckpoint], load_state_dict=not args.no_pretraining,
            device=device)
    criterion = CTCPhoneCriterionCV(
        hidden_gar, n_phones, args.LSTM, size_kernel=args.kernelSize,
        seq_norm=args.seqNorm, dropout=args.dropout,
        reduction=args.loss_reduction,
        generator=torch.Generator().manual_seed(args.seed))

    print(f"Loading the validation dataset at {args.pathDB}")
    dataset_val = SingleSequenceDataset(args.pathDB, seq_val, phone_labels,
                                        in_dim=args.in_dim)
    path_checkpoint = os.path.join(args.output, "checkpoint.pt")
    frozen = args.command == "train" and args.freeze
    state = create_train_state(model, criterion, device,
                               getattr(args, "lr", 2e-4),
                               getattr(args, "beta1", 0.9),
                               getattr(args, "beta2", 0.999),
                               getattr(args, "epsilon", 1e-8),
                               train_model=not frozen)
    val_step, predict_step = make_eval_steps(state, device, downsampling)

    if args.command == "train":
        if args.debug:
            random.shuffle(seq_train)
            seq_train = seq_train[:1000]
        print(f"Loading the training dataset at {args.pathDB}")
        dataset_train = SingleSequenceDataset(args.pathDB, seq_train,
                                              phone_labels,
                                              in_dim=args.in_dim)
        with open(os.path.join(args.output, "args_training.json"),
                  "w") as f:
            json.dump({**vars(args), "command": "train"}, f, indent=2)
        train_step = make_train_step(state, device, frozen, downsampling)
        run_training(dataset_train, dataset_val, train_step, val_step,
                     state, args.batchSize, args.nEpochs, path_checkpoint,
                     seed=args.seed)
        return 0

    print(f"Loading data at {path_checkpoint}")
    model_sd, classifier_sd, best_loss = load_cv_checkpoint(path_checkpoint)
    if best_loss is not None:
        print(f"Best loss : {best_loss}")
    state.model.load_state_dict(model_sd)
    state.criterion.load_state_dict(classifier_sd)
    with open(os.path.join(args.output, f"args_validation_{args.name}.json"),
              "w") as f:
        json.dump(vars(args), f, indent=2)
    per_step(dataset_val, predict_step, args.batchSize, downsampling,
             criterion.blank_label)
    return 0


if __name__ == "__main__":
    sys.exit(main())
