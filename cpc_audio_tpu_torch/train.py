"""CPC pretraining and supervised-probe CLI of the port
(cpc_audio_tpu/train.py:37-409), one process a device.

Same flags (the port's copy of the JAX package's config), data loader
(its copy of the data package) and checkpoint directory contract as the
JAX trainer.  The step runs on the CUDA devices (the kernels), and
raises where there is none; only a caller that asks for it with
``main(argv, device="cpu")`` runs on the CPU (the plain versions, as the
tests do).  Loss and accuracy sums stay on the device and are read back
(averaged over ranks) at ``logging_step`` boundaries and at epoch end.

Several devices (``parallel/distributed.py``): ``--nGPU N`` on one host
starts N processes (``spawn``; -1 or 0: every local GPU, as JAX counts
its devices), rank r on ``cuda:r``; every rank builds the same loader
over the whole file list with the same seed, takes global batches of
``N * batchSizeGPU`` windows and trains on its rows of each.
``--distributed`` joins the group torchrun describes (one process a GPU,
on one host or several); each rank then loads its own shard of the file
list (``shard_sequences``) and takes batches of ``batchSizeGPU``, the
same number an epoch on every rank.  Rank 0 alone prints and writes checkpoints
and logs; every rank starts from rank 0's weights.  ``--supervised`` trains
a speaker probe, with ``--pathPhone`` a phone probe (``--CTC``: the CTC
one); ``--load`` and resume read checkpoints of the port, of the JAX
package and of the reference; ``--export_torch`` writes a
reference-format ``checkpoint_<epoch>.torch.pt`` beside each checkpoint.

Usage:
    python -m cpc_audio_tpu_torch.train --pathDB <dir> [--pathTrain x.txt]
        [--pathVal y.txt] --pathCheckpoint <out> [flags...]
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import time
from copy import deepcopy
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import checkpoint as ckpt
from . import convert
from ._common import precision_policy, resolve_device
from .config import (CPCConfig, TrainConfig, add_cpc_args,
                     config_from_namespace)
from .criterion import (CTCPhoneCriterion, PhoneCriterion,
                        SpeakerCriterion, build_criterion)
from .data import (AudioBatchData, filter_seqs, find_all_seqs,
                   parse_seq_labels)
from .models import build_model
from .parallel import distributed
from .parallel.train_step import (TrainState, create_train_state, epoch_key,
                                  make_train_step, make_val_step,
                                  step_streams)
from .utils import misc as utils
from .utils.profiling import ThroughputMeter, profile_trace


def get_criterion(config: CPCConfig, train_config: TrainConfig,
                  n_speakers: int, n_phones: int,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.nn.Module:
    """Criterion routing (cpc_audio_tpu/train.py:37-64): the CPC criterion
    unless ``--supervised``; then a phone probe with ``--pathPhone`` (CTC
    with ``--CTC``), else a speaker probe, on the context (hiddenGar) or,
    with ``--onEncoder``, the encoding.  ``--cpc_mode none`` gives the
    zero loss, ``--speakerEmbedding`` an embedding over ``n_speakers``."""
    if not train_config.supervised:
        return build_criterion(config, generator, n_speakers)
    dim = config.hiddenEncoder if config.onEncoder else config.hiddenGar
    if train_config.pathPhone is not None:
        if not train_config.CTC:
            return PhoneCriterion(dim, n_phones, config.onEncoder,
                                  n_layers=config.nLevelsPhone,
                                  generator=generator)
        return CTCPhoneCriterion(dim, n_phones, config.onEncoder,
                                 generator=generator)
    return SpeakerCriterion(dim, n_speakers, generator=generator)


def _read_back(sums: Dict[str, torch.Tensor]) -> Tuple[np.ndarray, ...]:
    """The metric sums on the host, averaged over ranks (``pmean``)."""
    out = [sums["losses"].double(), sums["acc"].double()]
    distributed.mean_(out)
    return tuple(t.cpu().numpy() for t in out)


def train_epoch(loader, train_step, hidden, key: torch.Tensor,
                logging_step: int, use_labels: bool = False,
                meter: Optional[ThroughputMeter] = None
                ) -> Tuple[dict, object]:
    """One epoch (cpc_audio_tpu/train.py:73-127) over this rank's
    ``(batch, labels)``; the labels go to the criterion with
    ``use_labels`` (the supervised criteria).  ``meter`` counts the
    windows of every rank."""
    start_time = time.perf_counter()
    n_examples = 0
    logs, last_logs = {}, None
    dev_sums = None
    it = 0
    for step, (batch, labels) in enumerate(loader):
        n_examples += batch.shape[0]
        if meter is not None:
            meter.update(batch.shape[0] * distributed.world())
        hidden, metrics = train_step(batch, hidden, key,
                                     labels=labels if use_labels else None)
        dev_sums = metrics if dev_sums is None else \
            {k: dev_sums[k] + metrics[k] for k in dev_sums}
        it += 1
        if (step + 1) % logging_step == 0:
            losses, acc = _read_back(dev_sums)      # sync point
            logs = {"locLoss_train": losses, "locAcc_train": acc}
            elapsed = time.perf_counter() - start_time
            print(f"Update {step + 1}")
            print(f"elapsed: {elapsed:.1f} s")
            print(f"{1000.0 * elapsed / logging_step:.1f} ms per batch, "
                  f"{1000.0 * elapsed / n_examples:.1f} ms / example")
            loc_logs = utils.update_logs(logs, logging_step, last_logs)
            last_logs = deepcopy(logs)
            utils.show_logs("Training loss", loc_logs)
            start_time, n_examples = time.perf_counter(), 0
    if it:
        losses, acc = _read_back(dev_sums)
        logs = {"locLoss_train": losses, "locAcc_train": acc}
    logs = utils.update_logs(logs, it)
    logs["iter"] = it
    utils.show_logs("Average training loss on epoch", logs)
    return logs, hidden


def val_epoch(loader, val_step, hidden, key: torch.Tensor,
              use_labels: bool = False) -> Tuple[dict, object]:
    """Validation pass (cpc_audio_tpu/train.py:130-150): the round keys
    and negatives' seed of batch ``step`` derive from (key, step, rank)
    on the device."""
    logs = {}
    dev_sums = None
    it = 0
    step = torch.zeros((), dtype=torch.int64, device=key.device)
    rank = distributed.rank()
    for batch, labels in loader:
        _, keys, neg_seed = step_streams(key, step, rank)
        hidden, metrics = val_step(batch, hidden, round_keys=keys,
                                   neg_seed=neg_seed,
                                   labels=labels if use_labels else None)
        dev_sums = metrics if dev_sums is None else \
            {k: dev_sums[k] + metrics[k] for k in dev_sums}
        step += 1
        it += 1
    if it:
        losses, acc = _read_back(dev_sums)
        logs = {"locLoss_val": losses, "locAcc_val": acc}
    logs = utils.update_logs(logs, max(it, 1))
    logs["iter"] = it
    utils.show_logs("Validation loss:", logs)
    return logs, hidden


def _cpu_state(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True)
            for k, v in module.state_dict().items()}


def run(train_dataset: AudioBatchData, val_dataset: AudioBatchData,
        batch_size: int, config: CPCConfig, train_config: TrainConfig,
        state: TrainState, logs: dict, device: torch.device) -> None:
    """Epoch loop (cpc_audio_tpu/train.py:153-265); ``batch_size`` is a
    rank's.  Under ``--distributed`` each rank's datasets hold its own
    files and every rank takes as many batches; else the loaders give
    every rank the same global batches and each takes its rows."""
    world = distributed.world()
    rank0 = distributed.rank() == 0
    if train_config.distributed:
        loader_batch = batch_size

        def rank_batches(loader):
            return distributed.same_length(loader, device)
    else:
        loader_batch = batch_size * world

        def rank_batches(loader):
            return ((distributed.rank_rows(b), distributed.rank_rows(lab))
                    for b, lab in loader)
    train_step = make_train_step(state, device)
    val_step = make_val_step(state.model, state.criterion, device)
    # a carried state needs sequential windows and a recurrent AR
    # (cpc_audio_tpu/train.py:164-166)
    keep_hidden = config.samplingType == "sequential" \
        and config.arMode in ("GRU", "LSTM", "RNN")
    # the loader's labels: the probes' targets, or the speaker ids of the
    # CPC criterion's speaker embedding
    use_labels = train_config.supervised or config.speakerEmbedding > 0
    n_epoch = config.nEpoch
    start_epoch = len(logs["epoch"])
    best_acc = -1.0
    best_state = _cpu_state(state.model) if rank0 else None
    start_time = time.time()
    path_checkpoint = train_config.pathCheckpoint

    print(f"Running {n_epoch} epochs")
    for epoch in range(start_epoch, n_epoch):
        print(f"Starting epoch {epoch}")
        state.lr.fill_(utils.lr_for_epoch(
            config.learningRate, epoch, config.schedulerStep,
            config.schedulerRamp))
        train_loader = train_dataset.get_data_loader(
            loader_batch, config.samplingType, True)
        val_loader = val_dataset.get_data_loader(
            loader_batch, "sequential", False)
        print("Training dataset ~%d batches, Validation dataset ~%d"
              " batches, batch size %d" % (len(train_loader),
                                           len(val_loader), loader_batch))
        hidden = state.model.zero_state(batch_size, device) \
            if keep_hidden else None
        # one key per epoch, from (seed, absolute epoch): resume-reproducible
        ekey = epoch_key(config.random_seed or 0, 2 * epoch, device)
        vkey = epoch_key(config.random_seed or 0, 2 * epoch + 1, device)
        meter = ThroughputMeter(world)
        with profile_trace(train_config.profile_dir
                           if epoch == start_epoch and rank0 else None):
            loc_logs_train, hidden = train_epoch(
                rank_batches(train_loader), train_step, hidden, ekey,
                logs["logging_step"], use_labels, meter)
        print(f"epoch throughput: {meter.summary()}")
        loc_logs_val, hidden = val_epoch(rank_batches(val_loader),
                                         val_step, hidden, vkey, use_labels)
        print(f"Ran {epoch + 1} epochs "
              f"in {time.time() - start_time:.2f} seconds")

        if "locAcc_val" in loc_logs_val:
            current_acc = float(np.mean(loc_logs_val["locAcc_val"]))
        elif "locAcc_train" in loc_logs_train:
            print("WARNING: validation set smaller than one batch; "
                  "tracking best checkpoint on train accuracy")
            current_acc = float(np.mean(loc_logs_train["locAcc_train"]))
        else:
            print("WARNING: neither split produced a batch this epoch; "
                  "best checkpoint unchanged")
            current_acc = best_acc
        if current_acc > best_acc:
            best_acc = current_acc
            best_state = _cpu_state(state.model) if rank0 else None

        for k, v in dict(loc_logs_train, **loc_logs_val).items():
            if k not in logs:
                logs[k] = [None for _ in range(epoch)]
            if isinstance(v, np.ndarray):
                v = v.tolist()
            logs[k].append(v)
        logs["epoch"].append(epoch)

        if path_checkpoint is not None and rank0 and (
                epoch % logs["saveStep"] == 0 or epoch == n_epoch - 1):
            ckpt.save_checkpoint(
                state.model, state.criterion, state.optimizer, best_state,
                int(state.step),
                os.path.join(path_checkpoint, f"checkpoint_{epoch}.pt"))
            if train_config.export_torch:
                convert.export_torch_checkpoint(
                    state.model, config, os.path.join(
                        path_checkpoint, f"checkpoint_{epoch}.torch.pt"))
            utils.save_logs(logs, os.path.join(path_checkpoint,
                                               "checkpoint_logs.json"))
        # the other ranks wait for rank 0's files
        distributed.barrier()


def main(argv=None, device=None) -> int:
    """Train from the command line ``argv``; ``device`` as
    :func:`resolve_device`.  ``--distributed`` joins torchrun's group;
    else ``--nGPU`` > 1 device (the CPU: ``--nGPU`` itself) starts that
    many ranks (module doc)."""
    args = parse_args(argv)
    if args.distributed:
        with distributed.env_group(device) as dev:
            return _main(dev, args)
    n = distributed.resolve_world(args.nGPU, device)
    if n > 1:
        return distributed.spawn(_main, n, device or "cuda", (args,))
    return _main(resolve_device(device), args)


def _main(device: torch.device, args: argparse.Namespace) -> int:
    """One rank of the trainer (the only one without a process group)."""
    precision_policy()
    cpc_config = config_from_namespace(args)
    train_config = TrainConfig.from_dict(vars(args))

    # every rank takes rank 0's seed: the same split, loaders and weights
    seed = distributed.agree_int(utils.set_seed(cpc_config.random_seed),
                                 device)
    utils.set_seed(seed)
    cpc_config = cpc_config.replace(random_seed=seed)
    logs = {"epoch": [], "iter": [], "saveStep": train_config.save_step,
            "logging_step": train_config.logging_step}

    load_optimizer = False
    load_paths = list(train_config.load) if train_config.load else None
    if train_config.pathCheckpoint is not None \
            and not train_config.restart \
            and ckpt.get_checkpoint_data(train_config.pathCheckpoint):
        path_ckpt, logs_loaded, _, raw_args = \
            ckpt.get_checkpoint_data(train_config.pathCheckpoint)
        merged = ckpt.merge_args(
            {**cpc_config.to_dict(), **train_config.to_dict()}, raw_args,
            ckpt.FORBIDDEN_RESUME_ATTRS)
        cpc_config = CPCConfig.from_dict(merged)
        train_config = TrainConfig.from_dict(
            {**train_config.to_dict(),
             **{k: v for k, v in merged.items()
                if k not in ckpt.FORBIDDEN_RESUME_ATTRS}})
        logs.update(logs_loaded)
        logs.setdefault("logging_step", train_config.logging_step)
        load_paths = [path_ckpt]
        load_optimizer = True
        print(f"Resuming from checkpoint {path_ckpt}")

    for title, cfg in (("CONFIG", cpc_config), ("RUN CONFIG", train_config)):
        print(f"{title}:\n"
              f"{json.dumps(cfg.to_dict(), indent=4, sort_keys=True)}")

    if not os.path.isdir(train_config.pathDB):
        print(f"ERROR: --pathDB {train_config.pathDB} is not a directory")
        return 1
    seq_names, speakers = find_all_seqs(
        train_config.pathDB, extension=train_config.file_extension,
        load_cache=not train_config.ignore_cache)
    if not seq_names:
        print(f"ERROR: no '{train_config.file_extension}' sequences found "
              f"under {train_config.pathDB}")
        return 1
    seq_train = filter_seqs(train_config.pathTrain, seq_names) \
        if train_config.pathTrain is not None else seq_names
    if train_config.pathVal is None:
        shuffled = list(seq_train)          # random 99/1 split
        random.shuffle(shuffled)
        size_train = int(0.99 * len(shuffled))
        seq_train, seq_val = shuffled[:size_train], shuffled[size_train:]
    else:
        seq_val = filter_seqs(train_config.pathVal, seq_names)
    if train_config.debug:
        seq_train, seq_val = seq_train[:2000], seq_val[:2000]
    if train_config.distributed:
        # each rank loads only its shard of the file list
        seq_train = distributed.shard_sequences(seq_train)
        seq_val = distributed.shard_sequences(seq_val)

    phone_labels, n_phones = None, 0
    if train_config.supervised and train_config.pathPhone is not None:
        print("Loading the phone labels at " + train_config.pathPhone)
        phone_labels, n_phones = parse_seq_labels(train_config.pathPhone)

    print(f"Loading audio data at {train_config.pathDB}")
    datasets = [AudioBatchData(
        train_config.pathDB, cpc_config.sizeWindow, seqs, phone_labels,
        len(speakers), n_process_loader=train_config.n_process_loader,
        max_size_loaded=train_config.max_size_loaded, seed=seed)
        for seqs in (seq_train, seq_val)]

    batch_size = train_config.batchSizeGPU
    if train_config.distributed:
        print(f"--nGPU {train_config.nGPU}: one process a device under "
              f"--distributed")
    print(f"Let's use {distributed.world()} devices ({device} on rank "
          f"{distributed.rank()})!")
    gen = torch.Generator().manual_seed(seed)
    model = build_model(cpc_config, gen)
    # build_model sets hiddenGar for no_ar / transformer: the criterion and
    # the sidecar follow it (cpc_audio_tpu/train.py:373-376)
    cpc_config = model.config
    criterion = get_criterion(cpc_config, train_config, len(speakers),
                              n_phones, gen)
    state = create_train_state(model, criterion, device,
                               cpc_config.learningRate, cpc_config.beta1,
                               cpc_config.beta2, cpc_config.epsilon)
    if load_paths:
        convert.load_state_into(state, load_paths[0], cpc_config,
                                train_config.loadCriterion or load_optimizer,
                                load_optimizer)
    # the same start on every rank: rank 0's weights and buffers
    distributed.broadcast_([*state.model.state_dict().values(),
                            *state.criterion.state_dict().values()])
    if train_config.pathCheckpoint is not None and distributed.rank() == 0:
        os.makedirs(train_config.pathCheckpoint, exist_ok=True)
        ckpt.save_args_sidecar(train_config.pathCheckpoint, cpc_config,
                               train_config)
    run(*datasets, batch_size, cpc_config, train_config, state, logs,
        device)
    return 0


def parse_args(argv=None) -> argparse.Namespace:
    """The JAX trainer's flags (cpc_audio_tpu/train.py:412-453)."""
    parser = argparse.ArgumentParser(description="CPC trainer (PyTorch)")
    parser = add_cpc_args(parser)
    d = TrainConfig()
    g = parser.add_argument_group("Dataset")
    g.add_argument("--pathDB", type=str, default=d.pathDB)
    g.add_argument("--file_extension", type=str, default=d.file_extension)
    g.add_argument("--pathTrain", type=str, default=d.pathTrain)
    g.add_argument("--pathVal", type=str, default=d.pathVal)
    g.add_argument("--n_process_loader", type=int, default=d.n_process_loader)
    g.add_argument("--ignore_cache", action="store_true")
    g.add_argument("--max_size_loaded", type=int, default=d.max_size_loaded)
    g = parser.add_argument_group("Supervised mode")
    g.add_argument("--supervised", action="store_true")
    g.add_argument("--pathPhone", type=str, default=d.pathPhone)
    g.add_argument("--CTC", action="store_true")
    g = parser.add_argument_group("Save")
    g.add_argument("--pathCheckpoint", type=str, default=d.pathCheckpoint)
    g.add_argument("--logging_step", type=int, default=d.logging_step)
    g.add_argument("--save_step", type=int, default=d.save_step)
    g = parser.add_argument_group("Load")
    g.add_argument("--load", type=str, default=None, nargs="*")
    g.add_argument("--loadCriterion", action="store_true")
    g.add_argument("--restart", action="store_true")
    g = parser.add_argument_group("Device")
    g.add_argument("--nGPU", type=int, default=d.nGPU)
    g.add_argument("--batchSizeGPU", type=int, default=d.batchSizeGPU)
    parser.add_argument("--debug", action="store_true")
    g = parser.add_argument_group("Profiling and distribution")
    g.add_argument("--profile_dir", type=str, default=d.profile_dir,
                   help="Write a torch.profiler trace of the first epoch")
    g.add_argument("--distributed", action="store_true")
    g.add_argument("--export_torch", action="store_true")
    args = parser.parse_args(argv)
    if args.pathDB is None:
        parser.error("--pathDB is required")
    return args


if __name__ == "__main__":
    sys.exit(main())
