"""Linear separability probes of the port: speaker, phone and CTC-phone
(cpc_audio_tpu/eval/linear_separability.py).

Trains a probe criterion on frozen (default) or fine-tuned CPC features,
one process a device: ``--nGPU N`` starts N ranks (``parallel/
distributed.py``; -1: every local GPU), each building the same loaders
with global batches of ``batchSizeGPU * N`` and training on its rows;
the gradients are summed over ranks and the metrics averaged, as the
JAX probe's ``psum`` and ``pmean``, and rank 0 alone prints and writes.
Frozen, the model's forward runs under ``torch.no_grad``
(the JAX package's ``stop_gradient``), so K1's forward keeps no residuals
and Adam updates the criterion alone; ``--unfrozen`` trains the model in
train mode with it, K1 forward and backward.  The per-step dropout seed
derives from (seed, epoch) and the step counter on the device
(``parallel/train_step.step_streams``).  Metric sums stay on the device
and are read back once an epoch.  Writes ``checkpoint_<epoch>.pt`` (the
port's format, with the best state), ``checkpoint_logs.json`` and the
``checkpoint_args.json`` sidecar (the model's config, the flags and
``onEncoder``), which ``feature_loader.load_model`` and
``load_supervised_criterion`` read back.

Usage:
    python -m cpc_audio_tpu_torch.eval.linear_separability DB TRAIN VAL \
        CKPT [--pathPhone P [--CTC]] [--unfrozen] [--get_encoded] ...
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from typing import Callable, Dict

import numpy as np
import torch

from .. import checkpoint as ckpt
from .._common import precision_policy, resolve_device
from ..criterion import CTCPhoneCriterion, PhoneCriterion, SpeakerCriterion
from ..data import AudioBatchData, filter_seqs, find_all_seqs, parse_seq_labels
from ..feature_loader import load_model
from ..parallel import distributed
from ..parallel.train_step import (TrainState, _labels, _to_device,
                                   create_train_state, epoch_key,
                                   reduce_grads, step_streams)
from ..utils import misc as utils


def make_probe_step(state: TrainState, device, frozen: bool,
                    train: bool) -> Callable:
    """``step(batch, labels, key=None) -> {"losses": (1,), "acc": (1,)}``
    as device tensors, without a host sync.

    ``train``: one forward, the backward of the summed losses, the
    gradients summed over ranks (frozen: the criterion's alone, as JAX's
    ``psum``) and an Adam step; ``state.step`` advances.  Frozen, the
    model runs under ``no_grad`` and in eval mode; else in train mode, its
    dropout seed from (``key``, ``state.step``, rank).  Not ``train``: the
    validation step, under ``inference_mode``.  The metrics are the
    rank's."""
    precision_policy()
    device = torch.device(device)
    rank = distributed.rank()

    def step(batch, labels, key=None) -> Dict[str, torch.Tensor]:
        batch = _to_device(batch, device)
        labels = _labels(labels, device)
        if not train:
            state.model.eval()
            state.criterion.eval()
            with torch.inference_mode():
                c, z, _, _ = state.model(batch, labels)
                losses, acc = state.criterion(c, z, labels)
            return {"losses": losses, "acc": acc}
        if key is None:
            key = torch.zeros(1, dtype=torch.int64, device=device)
        seed = step_streams(key, state.step, rank)[0]
        state.optimizer.zero_grad(set_to_none=True)
        state.model.train(not frozen)
        state.criterion.train()
        with torch.no_grad() if frozen else contextlib.nullcontext():
            c, z, _, _ = state.model(batch, labels, train=not frozen,
                                     seed=seed)
        losses, acc = state.criterion(c, z, labels, train=True, seed=seed)
        losses.sum().backward()
        reduce_grads(state.optimizer)
        state.optimizer.step()
        state.step += 1
        return {"losses": losses.detach(), "acc": acc.detach()}

    return step


def _flat_state(state: TrainState) -> Dict[str, torch.Tensor]:
    """The model's and the criterion's parameters, ``model.*`` and
    ``criterion.*``, copied to the CPU."""
    return {f"{prefix}.{k}": v.detach().to("cpu", copy=True)
            for prefix, mod in (("model", state.model),
                                ("criterion", state.criterion))
            for k, v in mod.state_dict().items()}


def _epoch_means(dev_sums, it: int, suffix: str) -> dict:
    """One read-back an epoch: the means of the summed metrics, averaged
    over ranks."""
    if dev_sums is None:
        return {f"locLoss_{suffix}": np.asarray([0.0]),
                f"locAcc_{suffix}": np.asarray([0.0])}
    out = [dev_sums["losses"].double().mean(), dev_sums["acc"].double().mean()]
    distributed.mean_(out)
    return {f"locLoss_{suffix}": np.asarray([float(out[0]) / it]),
            f"locAcc_{suffix}": np.asarray([float(out[1]) / it])}


def run(state: TrainState, train_step, val_step, train_dataset,
        val_dataset, batch_size: int, n_epochs: int, save_step: int,
        path_checkpoint: str, logs: dict, seed: int = 0):
    """The epoch loop (cpc_audio_tpu/eval/linear_separability.py:102-186);
    ``batch_size`` is the global batch, whose rows the ranks share.
    Returns the best validation accuracy."""
    device = state.lr.device
    rank0 = distributed.rank() == 0
    start_epoch = len(logs["epoch"])
    best_acc = -1.0
    best_state = _flat_state(state) if rank0 else None
    start_time = time.time()
    for epoch in range(start_epoch, n_epochs):
        train_loader = train_dataset.get_data_loader(batch_size, "uniform",
                                                     True)
        val_loader = val_dataset.get_data_loader(batch_size, "sequential",
                                                 False)
        key = epoch_key(seed, epoch, device)
        means = {}
        for suffix, loader, step in (("train", train_loader, train_step),
                                     ("val", val_loader, val_step)):
            dev_sums, it = None, 0
            for batch, labels in loader:
                metrics = step(distributed.rank_rows(batch),
                               distributed.rank_rows(labels), key)
                dev_sums = metrics if dev_sums is None else \
                    {k: dev_sums[k] + metrics[k] for k in dev_sums}
                it += 1
            means.update(_epoch_means(dev_sums, max(it, 1), suffix))

        print("")
        print("_" * 50)
        print(f"Ran {epoch + 1} epochs in {time.time() - start_time:.2f} "
              f"seconds")
        utils.show_logs("Training loss", {k: v for k, v in means.items()
                                          if k.endswith("_train")})
        utils.show_logs("Validation loss", {k: v for k, v in means.items()
                                            if k.endswith("_val")})
        print("_" * 50)

        if float(means["locAcc_val"][0]) > best_acc:
            best_state = _flat_state(state) if rank0 else None
            best_acc = float(means["locAcc_val"][0])

        logs["epoch"].append(epoch)
        for k, v in means.items():
            if k not in logs:
                logs[k] = [None for _ in range(epoch)]
            logs[k].append(v.tolist())

        if rank0 and ((epoch % save_step == 0 and epoch > 0)
                      or epoch == n_epochs - 1):
            ckpt.save_checkpoint(
                state.model, state.criterion, state.optimizer, best_state,
                int(state.step),
                os.path.join(path_checkpoint, f"checkpoint_{epoch}.pt"))
            utils.save_logs(logs, os.path.join(path_checkpoint,
                                               "checkpoint_logs.json"))
        # the other ranks wait for rank 0's files
        distributed.barrier()
    return best_acc


def parse_args(argv):
    parser = argparse.ArgumentParser(
        description="Linear separability trainer "
                    "(default: speaker separability)")
    parser.add_argument("pathDB", type=str)
    parser.add_argument("pathTrain", type=str)
    parser.add_argument("pathVal", type=str)
    parser.add_argument("load", type=str, nargs="*")
    parser.add_argument("--pathPhone", type=str, default=None)
    parser.add_argument("--CTC", action="store_true")
    parser.add_argument("--pathCheckpoint", type=str, default="out")
    parser.add_argument("--nGPU", type=int, default=-1)
    parser.add_argument("--batchSizeGPU", type=int, default=8)
    parser.add_argument("--n_epoch", type=int, default=10)
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--unfrozen", action="store_true")
    parser.add_argument("--no_pretraining", action="store_true")
    parser.add_argument("--file_extension", type=str, default=".flac")
    parser.add_argument("--save_step", type=int, default=-1)
    parser.add_argument("--get_encoded", action="store_true")
    parser.add_argument("--lr", type=float, default=2e-4)
    parser.add_argument("--beta1", type=float, default=0.9)
    parser.add_argument("--beta2", type=float, default=0.999)
    parser.add_argument("--epsilon", type=float, default=2e-8)
    parser.add_argument("--ignore_cache", action="store_true")
    parser.add_argument("--size_window", type=int, default=20480)
    parser.add_argument("--random_seed", type=int, default=0)
    args = parser.parse_args(argv)
    if args.save_step <= 0:
        args.save_step = args.n_epoch
    args.load = [os.path.abspath(x) for x in args.load]
    args.pathCheckpoint = os.path.abspath(args.pathCheckpoint)
    return args


def build_probe(dim_features: int, n_speakers: int, phone_labels,
                n_phones: int, ctc: bool, on_encoder: bool,
                generator: torch.Generator) -> torch.nn.Module:
    """The probe criterion: phone (CTC with ``ctc``) where there are phone
    labels, else speaker."""
    if phone_labels is None:
        print("Running speaker separability")
        return SpeakerCriterion(dim_features, n_speakers, generator=generator)
    if not ctc:
        print("Running phone separability with aligned phones")
        return PhoneCriterion(dim_features, n_phones, on_encoder,
                              generator=generator)
    print("Running phone separability with CTC loss")
    return CTCPhoneCriterion(dim_features, n_phones, on_encoder,
                             generator=generator)


def main(argv=None, device=None) -> int:
    """Run the CLI on ``argv``, on ``device`` (default: the card; raises
    without one); ``--nGPU`` devices (the CPU: ``--nGPU`` ranks) start
    that many ranks."""
    args = parse_args(argv if argv is not None else sys.argv[1:])
    n = distributed.resolve_world(args.nGPU, device)
    if n > 1:
        return distributed.spawn(_main, n, device or "cuda", (args,))
    return _main(resolve_device(device), args)


def _main(device: torch.device, args: argparse.Namespace) -> int:
    """One rank of the CLI (the only one without a process group)."""
    precision_policy()
    logs = {"epoch": [], "iter": [], "saveStep": args.save_step}

    seq_names, speakers = find_all_seqs(args.pathDB,
                                        extension=args.file_extension,
                                        load_cache=not args.ignore_cache)
    model, hidden_gar, hidden_encoder = load_model(
        args.load, load_state_dict=not args.no_pretraining, device=device)
    dim_features = hidden_encoder if args.get_encoded else hidden_gar

    phone_labels, n_phones = None, 0
    if args.pathPhone is not None:
        phone_labels, n_phones = parse_seq_labels(args.pathPhone)
    criterion = build_probe(dim_features, len(speakers), phone_labels,
                            n_phones, args.CTC, args.get_encoded,
                            torch.Generator().manual_seed(args.random_seed))

    seq_train = filter_seqs(args.pathTrain, seq_names)
    seq_val = filter_seqs(args.pathVal, seq_names)
    if args.debug:
        seq_train = seq_train[:1000]
        seq_val = seq_val[:100]
    db_train, db_val = (AudioBatchData(args.pathDB, args.size_window, seqs,
                                       phone_labels, len(speakers),
                                       seed=args.random_seed)
                        for seqs in (seq_train, seq_val))

    frozen = not args.unfrozen
    print("Working with frozen features" if frozen
          else "Working in full fine-tune mode")
    state = create_train_state(model, criterion, device, args.lr,
                               args.beta1, args.beta2, args.epsilon,
                               train_model=not frozen)
    # the same start on every rank (--no_pretraining draws its weights)
    distributed.broadcast_([*model.state_dict().values(),
                            *criterion.state_dict().values()])
    train_step = make_probe_step(state, device, frozen, train=True)
    val_step = make_probe_step(state, device, frozen, train=False)

    n_ranks = distributed.world()
    print(f"Let's use {n_ranks} devices ({device} on rank "
          f"{distributed.rank()})!")
    if distributed.rank() == 0:
        os.makedirs(args.pathCheckpoint, exist_ok=True)
    # the args sidecar with the model's config, so that load_model and
    # load_supervised_criterion rebuild the probe from this directory
    config = model.config if hasattr(model, "config") \
        else model.models[0].config
    sidecar = dict(config.to_dict())
    sidecar.update(vars(args))
    sidecar["onEncoder"] = args.get_encoded
    if distributed.rank() == 0:
        with open(os.path.join(args.pathCheckpoint, "checkpoint_args.json"),
                  "w") as f:
            json.dump(sidecar, f, indent=2)

    run(state, train_step, val_step, db_train, db_val,
        args.batchSizeGPU * n_ranks, args.n_epoch, args.save_step,
        args.pathCheckpoint, logs, seed=args.random_seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
