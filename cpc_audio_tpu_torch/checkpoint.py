"""Checkpoints of the port's trainer (cpc_audio_tpu/checkpoint.py, whose
module imports JAX, re-implemented for torch).

Same directory contract as the JAX package: ``checkpoint_<epoch>.pt``
beside the sidecars ``checkpoint_logs.json`` and ``checkpoint_args.json``.
A checkpoint is a ``torch.save`` zip holding the state dicts of the model
(``gEncoder``), the criterion (``cpcCriterion``), the optimizer
(``optimizer``) and the best model so far (``best``).  Loading a JAX-format
checkpoint (a plain pickle) raises: ROADMAP Queue 1 item 8.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

from .config import CPCConfig, TrainConfig

FORMAT = "cpc_audio_tpu_torch"

# resume must not override run-control attributes (the JAX package's
# FORBIDDEN_RESUME_ATTRS, nEpoch included so a run can be extended)
FORBIDDEN_RESUME_ATTRS = {"nGPU", "pathCheckpoint", "debug", "restart",
                          "world_size", "n_nodes", "node_id",
                          "n_gpu_per_node", "load", "nEpoch"}


def save_checkpoint(model: torch.nn.Module, criterion: torch.nn.Module,
                    optimizer: torch.optim.Optimizer,
                    best_state: Dict[str, torch.Tensor], step: int,
                    path: str) -> None:
    """Write ``path`` atomically (tmp file + rename)."""
    data = {"format": FORMAT, "version": 1, "step": step,
            "gEncoder": model.state_dict(),
            "cpcCriterion": criterion.state_dict(),
            "optimizer": optimizer.state_dict(), "best": best_state}
    tmp = path + ".tmp"
    torch.save(data, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Load a checkpoint of the port (tensors and containers only)."""
    with open(path, "rb") as f:
        head = f.read(4)
    if head != b"PK\x03\x04":        # not a torch.save zip: JAX pickle
        raise NotImplementedError(
            f"{path} is not a checkpoint of the port; loading JAX-format "
            f"checkpoints is ROADMAP Queue 1 item 8")
    data = torch.load(path, map_location="cpu", weights_only=True)
    if data.get("format") != FORMAT:
        raise ValueError(f"{path}: unknown checkpoint format "
                         f"{data.get('format')!r}")
    return data


def save_args_sidecar(path_dir: str, cpc_config: CPCConfig,
                      train_config: Optional[TrainConfig] = None) -> None:
    """Write checkpoint_args.json atomically."""
    args = dict(cpc_config.to_dict())
    if train_config is not None:
        args.update(train_config.to_dict())
    dest = os.path.join(path_dir, "checkpoint_args.json")
    with open(dest + ".tmp", "w") as f:
        json.dump(args, f, indent=2, sort_keys=True)
    os.replace(dest + ".tmp", dest)


def checkpoint_epoch(name: str) -> Optional[int]:
    """The epoch of ``checkpoint_<epoch>.pt``, else None."""
    stem, ext = os.path.splitext(os.path.basename(name))
    if ext != ".pt" or not stem.startswith("checkpoint_") \
            or not stem[11:].isdigit():
        return None
    return int(stem[11:])


def get_checkpoint_data(path_dir: str
                        ) -> Optional[Tuple[str, dict, CPCConfig, dict]]:
    """(latest checkpoint path, logs, config, raw args) or None."""
    if not os.path.isdir(path_dir):
        return None
    found = [(checkpoint_epoch(x), x) for x in os.listdir(path_dir)]
    found = sorted(f for f in found if f[0] is not None)
    if not found:
        return None
    logs, raw_args = {}, {}
    for name, target in (("checkpoint_logs.json", logs),
                         ("checkpoint_args.json", raw_args)):
        p = os.path.join(path_dir, name)
        if os.path.exists(p):
            with open(p) as f:
                target.update(json.load(f))
    config = CPCConfig.from_dict({**CPCConfig().to_dict(), **raw_args})
    return (os.path.abspath(os.path.join(path_dir, found[-1][1])), logs,
            config, raw_args)


def merge_args(base: dict, loc: dict,
               forbidden: Optional[set] = None) -> dict:
    """``loc`` overrides ``base`` except for the ``forbidden`` keys."""
    out = dict(base)
    out.update({k: v for k, v in loc.items()
                if forbidden is None or k not in forbidden})
    return out
