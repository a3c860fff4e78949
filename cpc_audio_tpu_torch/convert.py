"""Weights of the JAX package -> state dicts of the port.

``params_from_jax`` takes the JAX package's parameter tree
``{"model": ..., "criterion": ...}`` (``TrainState.params``) with numpy
leaves and returns one flat state dict, keys prefixed ``model.`` and
``criterion.``:

* encoder conv kernels, stored (W, in, out) ('WIO'), become torch's
  (out, in, W) ``weight``;
* the recurrent ARs' ``weight_ih_t (C, G*H)`` / ``weight_hh_t (H, G*H)``
  (LSTM G = 4, GRU G = 3, RNN G = 1) become torch's ``weight_ih (G*H, C)``
  / ``weight_hh (G*H, H)``;
* everything else keeps its name and shape: the K-stacked head tree, and
  the transformer AR's ``gAR.layer0.multihead.{Wq,Wk,Wv,Wo}.kernel``,
  ``multihead.Krelpos``, ``ffnetwork.lin{1,2}.{kernel,bias}`` and
  ``ln_*``, whose ``(in, out)`` kernel layout the port keeps
  (models/transformer.py).

The mapping is linear and leaf by leaf, so a gradient tree of the same
structure (or an optimizer moment tree) maps through it the same way:
the tests compare the two packages' gradients leaf by leaf with it.

``load_jax_params`` loads such a tree into a model and a criterion.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch


def _flatten(tree: Dict[str, Any], prefix: str = ""
             ) -> Iterator[Tuple[str, np.ndarray]]:
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", np.asarray(value)


def _convert_leaf(key: str, value: np.ndarray) -> Tuple[str, np.ndarray]:
    parts = key.split(".")
    if "gEncoder" in parts and parts[-2].startswith("conv") \
            and parts[-1] == "kernel":
        return ".".join(parts[:-1] + ["weight"]), value.transpose(2, 1, 0)
    if "gAR" in parts and parts[-1] in ("weight_ih_t", "weight_hh_t"):
        return ".".join(parts[:-1] + [parts[-1][:-2]]), value.T
    return key, value


def params_from_jax(jax_params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flat state dict (``model.*``, ``criterion.*``) of the port."""
    out = {}
    for key, value in _flatten(jax_params):
        key, value = _convert_leaf(key, value)
        # copy: never alias the caller's (possibly device-backed) buffers
        out[key] = torch.from_numpy(np.array(value, dtype=np.float32))
    return out


def load_jax_params(model: torch.nn.Module, criterion: torch.nn.Module,
                    jax_params: Dict[str, Any]) -> None:
    """Load the JAX parameter tree into ``model`` and ``criterion``
    (strict: every parameter of both must be present)."""
    sd = params_from_jax(jax_params)
    for prefix, module in (("model.", model), ("criterion.", criterion)):
        module.load_state_dict({k[len(prefix):]: v for k, v in sd.items()
                                if k.startswith(prefix)})
