"""Checkpoints of the port's trainer (cpc_audio_tpu/checkpoint.py, whose
module imports JAX, re-implemented for torch).

Same directory contract as the JAX package: ``checkpoint_<epoch>.pt``
beside the sidecars ``checkpoint_logs.json`` and ``checkpoint_args.json``.
A checkpoint is a ``torch.save`` zip holding the state dicts of the model
(``gEncoder``), the criterion (``cpcCriterion``), the optimizer
(``optimizer``) and the best model so far (``best``).

``load_checkpoint`` reads three formats and marks each in ``"format"``:

* the port's own (``FORMAT``);
* the JAX package's pickle (``JAX_FORMAT``, version ``JAX_FORMAT_VERSION``)
  of numpy trees: ``gEncoder`` and ``cpcCriterion`` parameter trees, the
  optax state ``optimizer`` and ``best``.  It is read without JAX, flax or
  optax: :class:`_JaxFreeUnpickler` turns their classes into plain
  tuples and dicts, and refuses every class it does not know by name;
* a reference-layout torch checkpoint (``"torch"``), as the reference
  trainer and ``convert.export_torch_checkpoint`` write it.
"""

from __future__ import annotations

import io
import json
import os
import pickle
from typing import Any, Dict, Optional, Tuple

import torch

from .config import CPCConfig, TrainConfig

FORMAT = "cpc_audio_tpu_torch"
JAX_FORMAT = "cpc_audio_tpu"
# the JAX package's FORMAT_VERSION: v2 stores linear and recurrent kernels
# (in, out); v1 checkpoints are refused, as the JAX package refuses them
JAX_FORMAT_VERSION = 2

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


# what a JAX-format pickle may name besides the JAX stack's classes: the
# numpy arrays of its leaves (np.asarray of every leaf, JAX's
# to_numpy_tree), under numpy 1's and numpy 2's module names
_PICKLE_ALLOWED = {
    ("numpy", "ndarray"), ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"), ("numpy._core.multiarray", "scalar"),
}
_JAX_STACK = ("jax", "jaxlib", "flax", "optax")


def _stand_in(module: str, name: str):
    """A plain stand-in for a class of the JAX stack: flax's FrozenDict
    becomes a dict, anything else (optax's state NamedTuples, such as
    ``ScaleByAdamState(count, mu, nu)`` and ``EmptyState()``) a tuple of
    its fields in order."""
    if name == "FrozenDict":
        return dict

    class StandIn(tuple):
        def __new__(cls, *fields):
            return tuple(fields)
    StandIn.__name__ = StandIn.__qualname__ = name
    return StandIn


class _JaxFreeUnpickler(pickle.Unpickler):
    """Reads the JAX package's checkpoint pickle without importing JAX,
    flax or optax (see :func:`_stand_in`); refuses any other class."""

    def find_class(self, module: str, name: str):
        if module.split(".")[0] in _JAX_STACK:
            return _stand_in(module, name)
        if (module, name) in _PICKLE_ALLOWED:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"refusing to load {module}.{name} from a checkpoint pickle")


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Load a checkpoint of any of the three formats (module doc), on the
    CPU.  A JAX-format pickle older than ``JAX_FORMAT_VERSION`` raises."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:4] != b"PK\x03\x04":        # not a torch.save zip: JAX pickle
        data = _JaxFreeUnpickler(io.BytesIO(raw)).load()
        if not isinstance(data, dict) or data.get("format") != JAX_FORMAT:
            raise ValueError(f"{path} is not a checkpoint: neither a torch "
                             f"zip nor a pickle of format {JAX_FORMAT!r}")
        version = data.get("version", 1)
        if version < JAX_FORMAT_VERSION:
            raise ValueError(
                f"{path} uses checkpoint format v{version} "
                f"(pre-transposed-kernel layout); this build reads "
                f"v{JAX_FORMAT_VERSION}. Re-train or re-export the "
                f"checkpoint.")
        return data
    data = torch.load(io.BytesIO(raw), map_location="cpu", weights_only=True)
    if not isinstance(data, dict):
        raise ValueError(f"{path}: a torch file, but not a checkpoint dict")
    if data.get("format") != FORMAT:
        data = dict(data, format="torch")        # reference layout
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
