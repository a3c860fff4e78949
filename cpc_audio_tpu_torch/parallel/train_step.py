"""Train and validation steps of the port
(cpc_audio_tpu/parallel/train_step.py:75-228), one process a device.

* The backward objective is the sum over prediction steps of the
  per-step mean CE, as ``jnp.sum(losses)`` there.
* Adam is ``torch.optim.Adam``, the same update as optax
  ``scale_by_adam(eps_root=0)`` followed by ``p + lr * u``.  The learning
  rate is a tensor on the device (``TrainState.lr``), so a schedule
  changes it in place without a host sync.  On a CUDA device the
  optimizer runs with ``capturable=True`` (its step counts stay on the
  device); on the CPU, where torch supports no capturable Adam, it runs
  the plain single-tensor loop.
* Parameters and optimizer moments are updated in place: PyTorch's
  modules own them, where JAX returned a new ``TrainState``.
* The per-step dropout seed, Feistel round keys and negatives' seed
  derive from (epoch key, step, rank) on the device
  (``ops/dropout.step_words``), the role of ``stream_keys``, so a step
  needs no host sync; rank 0 draws the words one device drew before.
  The one seed feeds every dropout of the step (the transformer AR's and
  the heads'), kept apart by the sites of ``ops/dropout.py``; the
  negatives' seed feeds the exact and rolled samplers' indices
  (``dropout.negative_indices``).
* ``labels`` (the loader's, numpy or torch) go to the criterion: the
  supervised criteria need them (speaker ids (B,), or frame-aligned phones
  (B, sizeWindow // 160)), and so does the CPC criterion's speaker
  embedding (speaker ids); else the CPC criterion is called with None.
* In training the model runs with ``train=True``, so batchNorm's running
  statistics move in place, as JAX's ``mutable=["batch_stats"]``.
* A parameter outside the loss's graph takes a zero gradient, as
  ``jax.grad`` gives it, so Adam still counts the step: under
  ``--cpc_mode none`` (a loss with no graph) the parameters stay as they
  are, the count advances and the moments stay zero.
* In a process group (``parallel/distributed.py``) each rank runs the
  step on its rows; after the zero-fill every gradient is summed over
  ranks (``psum``: the objective is the rank-summed loss, as the JAX
  step's), in one flat buffer per dtype, and every rank takes the same
  Adam step, so their parameters and moments stay bit-identical.
  batchNorm normalises with the rank's own batch moments, and after the
  step its running statistics are averaged over ranks (``pmean``; not
  ``torch.nn.SyncBatchNorm``, whose forward takes global moments).  No
  ``DistributedDataParallel``: it averages gradients, re-broadcasts rank
  0's buffers every forward and stalls on parameters outside the loss's
  graph.  Metrics stay per rank; the epoch loops average them over ranks
  where they read them back.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .._common import precision_policy
from ..criterion.infonce import NoneCriterion
from ..models.norms import BatchNorm
from ..ops import dropout
from ..ops.feistel import ROUNDS
from . import distributed


def make_optimizer(params, lr: torch.Tensor, beta1: float = 0.9,
                   beta2: float = 0.999,
                   epsilon: float = 1e-8) -> torch.optim.Adam:
    """Adam over ``params`` with the tensor learning rate ``lr``."""
    on_device = lr.device.type == "cuda"
    return torch.optim.Adam(params, lr=lr, betas=(beta1, beta2), eps=epsilon,
                            capturable=on_device, foreach=on_device)


@dataclass
class TrainState:
    """What a train step reads and updates: the two modules (parameters in
    place), the optimizer, the learning rate and the step count, both
    tensors on the device."""
    model: torch.nn.Module
    criterion: torch.nn.Module
    optimizer: torch.optim.Adam
    lr: torch.Tensor
    step: torch.Tensor


def create_train_state(model: torch.nn.Module, criterion: torch.nn.Module,
                       device, lr: float = 2e-4, beta1: float = 0.9,
                       beta2: float = 0.999, epsilon: float = 1e-8,
                       train_model: bool = True) -> TrainState:
    """Move both modules to ``device`` and build their optimizer, over the
    criterion's parameters and, with ``train_model``, the model's (the
    eval CLIs' frozen probes train the criterion alone)."""
    device = torch.device(device)
    model.to(device)
    criterion.to(device)
    lr_t = torch.tensor(lr, dtype=torch.float32, device=device)
    params = list(criterion.parameters())
    if train_model:
        params = list(model.parameters()) + params
    opt = make_optimizer(params, lr_t, beta1, beta2, epsilon)
    return TrainState(model, criterion, opt, lr_t,
                      torch.zeros((), dtype=torch.int64, device=device))


def epoch_key(seed: int, epoch: int, device) -> torch.Tensor:
    """The (1,) int64 key of one epoch's stream (``fold_in(base, epoch)``)."""
    words = dropout.bits(torch.tensor([seed & 0xFFFFFFFF]),
                         dropout.SITE_STEP_SEED, torch.tensor(epoch),
                         torch.tensor(0xFFFFFFFF))
    return words.reshape(1).to(device)


def step_streams(key: torch.Tensor, step: torch.Tensor, rank: int = 0
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dropout seed (1,), Feistel round keys (ROUNDS,), negatives' seed
    (1,)) for one step of ``rank``; the last is the word after the round
    keys.  Rank r takes the r-th run of words of each stream, so rank 0's
    are those of one device and other ranks draw their own."""
    seed = dropout.step_words(key, dropout.SITE_STEP_SEED, step, 1, rank)
    words = dropout.step_words(key, dropout.SITE_ROUND_KEYS, step,
                               ROUNDS + 1, rank * (ROUNDS + 1))
    return seed, words[:ROUNDS], words[ROUNDS:]


def batch_stats(model: torch.nn.Module) -> List[torch.Tensor]:
    """batchNorm's running statistics (the buffers the step moves)."""
    return [t for m in model.modules() if isinstance(m, BatchNorm)
            for t in (m.mean, m.var)]


def reduce_grads(optimizer: torch.optim.Optimizer) -> None:
    """Zero-fill the gradient of every parameter outside the loss's graph
    (``jax.grad``'s zeros: Adam still counts the step), then sum every
    gradient over ranks in place (``psum``), so that the ``p.grad``
    tensors Adam reads stay the same tensors."""
    grads = []
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
    distributed.sum_(grads)


def _to_device(batch, device: torch.device,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    if isinstance(batch, np.ndarray):
        batch = torch.from_numpy(batch)
    return batch.to(device=device, dtype=dtype, non_blocking=True)


def _labels(labels, device: torch.device) -> Optional[torch.Tensor]:
    return None if labels is None else _to_device(labels, device,
                                                  torch.int64)


def make_train_step(state: TrainState, device) -> Callable:
    """``train_step(batch, hidden=None, key=None, round_keys=None,
    negatives=None, labels=None) -> (hidden, {"losses": (K,), "acc":
    (K,)})`` (K = 1 for a supervised criterion).

    One forward (``train=True``), backward of ``losses.sum()`` and Adam
    step on ``state``; ``state.step`` advances by one.  ``key`` is the
    epoch's (1,) int64 device key (:func:`epoch_key`); ``round_keys``
    overrides the derived Feistel keys and ``negatives`` = (batch indices,
    time offsets) the exact or rolled sampler's derived draws (tests
    inject them).  In a process group ``batch`` is the rank's rows, the
    streams are the rank's, and the gradients and batchNorm statistics
    are reduced over ranks (module doc); the metrics are the rank's.
    Returns device tensors without synchronising."""
    precision_policy()
    device = torch.device(device)
    rank = distributed.rank()
    stats = batch_stats(state.model)

    def train_step(batch, hidden=None, key: Optional[torch.Tensor] = None,
                   round_keys: Optional[torch.Tensor] = None,
                   negatives: Optional[Tuple[torch.Tensor, ...]] = None,
                   labels=None) -> Tuple[object, Dict[str, torch.Tensor]]:
        batch = _to_device(batch, device)
        labels = _labels(labels, device)
        if key is None:
            key = torch.zeros(1, dtype=torch.int64, device=device)
        seed, keys, neg_seed = step_streams(key, state.step, rank)
        if round_keys is not None:
            keys = round_keys
        state.optimizer.zero_grad(set_to_none=True)
        state.model.train()
        state.criterion.train()
        c, z, labels, hid = state.model(batch, labels, hidden, train=True,
                                        seed=seed)
        losses, acc = state.criterion(c, z, labels, train=True,
                                      round_keys=keys, seed=seed,
                                      neg_seed=neg_seed, negatives=negatives)
        if not isinstance(state.criterion, NoneCriterion):
            losses.sum().backward()
        reduce_grads(state.optimizer)
        state.optimizer.step()
        distributed.mean_(stats)
        state.step += 1
        return hid, {"losses": losses.detach(), "acc": acc.detach()}

    return train_step


def make_val_step(model: torch.nn.Module, criterion: torch.nn.Module,
                  device: torch.device) -> Callable:
    """``val_step(batch, hidden=None, generator=None, round_keys=None,
    neg_seed=None, negatives=None, labels=None) -> (hidden, {"losses":
    (K,), "acc": (K,)})``.

    ``batch`` (B, 1, T) float waveforms, numpy or torch; ``generator``
    draws the negative samplers' round keys and negatives' seed unless
    ``round_keys`` and ``neg_seed`` (device tensors, from
    :func:`step_streams`) or ``negatives`` give them.  Runs under
    ``torch.inference_mode`` and returns device tensors without
    synchronising."""
    precision_policy()
    device = torch.device(device)

    def val_step(batch, hidden=None,
                 generator: Optional[torch.Generator] = None,
                 round_keys: Optional[torch.Tensor] = None,
                 neg_seed: Optional[torch.Tensor] = None,
                 negatives: Optional[Tuple[torch.Tensor, ...]] = None,
                 labels=None) -> Tuple[object, Dict[str, torch.Tensor]]:
        batch = _to_device(batch, device)
        labels = _labels(labels, device)
        with torch.inference_mode():
            c, z, labels, hid = model(batch, labels, hidden)
            losses, acc = criterion(c, z, labels, generator=generator,
                                    round_keys=round_keys, neg_seed=neg_seed,
                                    negatives=negatives)
        return hid, {"losses": losses, "acc": acc}

    return val_step
