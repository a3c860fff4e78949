"""Weights between the port and the two other layouts: the JAX package's
parameter trees and the reference's torch state dicts
(cpc_audio_tpu/convert.py, re-implemented without JAX).

Each layout is one table of ``(other key, port key, (to the port, back))``
rules, read in both directions by :func:`_relayout`.  A key holds
``{field}`` placeholders, each one dotted part (``{path}``: any dotted
prefix, empty too); the first rule whose key matches applies.

**JAX trees** (``_JAX``).  ``params_from_jax`` takes the JAX package's
parameter tree ``{"model": ..., "criterion": ...}`` (``TrainState.params``)
with numpy leaves and returns one flat state dict, keys prefixed ``model.``
and ``criterion.``:

* encoder conv kernels, stored (W, in, out) ('WIO'), become torch's
  (out, in, W) ``weight``;
* the recurrent ARs' ``weight_ih_t (C, G*H)`` / ``weight_hh_t (H, G*H)``
  (LSTM G = 4, GRU G = 3, RNN G = 1) become torch's ``weight_ih (G*H, C)``
  / ``weight_hh (G*H, H)``, and so do those of the Common Voice CTC
  head's LSTM (``conv1``);
* everything else keeps its name and shape: the K-stacked head tree, the
  transformer AR's ``gAR.layer0.multihead.{Wq,Wk,Wv,Wo}.kernel``,
  ``multihead.Krelpos``, ``ffnetwork.lin{1,2}.{kernel,bias}`` and
  ``ln_*``, whose ``(in, out)`` kernel layout the port keeps
  (models/transformer.py), and the supervised criteria's ``(in, out)``
  ``kernel`` and ``bias``.

The mapping is leaf by leaf, so an optimizer moment tree of the same
structure maps through it the same way (``load_state_into``);
``jax_tree`` is its inverse.

**Reference state dicts** (``gEncoder.*`` / ``gAR.*`` of a CPCModel, the
``cpcCriterion`` of the reference trainer; ``_ENCODER``, ``_RECURRENT``,
``_TRANSFORMER_LAYER``, ``_LINEAR``).  ``convert_cpc_model`` and
``convert_criterion`` read them into the port's state dicts;
``export_cpc_model``, ``export_torch_checkpoint`` and
``export_checkpoint_file`` (the CLI ``python -m cpc_audio_tpu_torch.convert
export <in> <out>``) write them.  Every linear and attention weight is
(out, in) there and transposes to the port's (in, out) ``kernel``; conv
and recurrent weights keep their torch layouts.  Variants the port does
not build (the bidirectional ARs, heads other than the transformer's,
batchNorm and its statistics, the lfb encoder, speaker embeddings) raise
``NotImplementedError``.
"""

from __future__ import annotations

import functools
import json
import os
import re
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import checkpoint as ckpt
from .config import CPCConfig

_NOT_PORTED = "is not ported yet: ROADMAP Queue 1 item 11 " \
              "(non-default variants)"

StateDict = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# The layout tables
# ---------------------------------------------------------------------------

def _same(x):
    return x


_SAME = (_same, _same)
_T = (lambda x: x.T, lambda x: x.T)
# conv kernels: the JAX package's (W, in, out) <-> torch's (out, in, W)
_WIO = (lambda x: np.transpose(x, (2, 1, 0)),) * 2
# ChannelNorm's affine: the reference's (1, C, 1) <-> the port's (C,)
_CHANNEL = (lambda x: x.reshape(-1), lambda x: x.reshape(1, -1, 1))

# the JAX package's leaves whose name or layout differ from the port's
_JAX = (("{path}gEncoder.conv{i}.kernel", "{path}gEncoder.conv{i}.weight",
         _WIO),
        ("{path}gAR.layer{l}.weight_{g}_t", "{path}gAR.layer{l}.weight_{g}",
         _T),
        # the Common Voice CTC head's LSTM (eval/common_voices.py)
        ("{path}conv1.weight_{g}_t", "{path}conv1.weight_{g}", _T),
        ("{path}{leaf}", "{path}{leaf}", _SAME))

# the reference's CPCEncoder (gEncoder.*)
_ENCODER = (("conv{i}.{p}", "conv{i}.{p}", _SAME),
            ("batchNorm{i}.{p}", "norm{i}.{p}", _CHANNEL))
# the reference's nn.LSTM / GRU / RNN AR (gAR.*)
_RECURRENT = (("baseNet.{p}_{g}_l{l}", "layer{l}.{p}_{g}", _SAME),)
# one reference TransformerLayer (the transformer AR's, a head's)
_TRANSFORMER_LAYER = (
    ("multihead.{w}.weight", "multihead.{w}.kernel", _T),
    ("multihead.Att.Krelpos", "multihead.Krelpos", _SAME),
    ("ffnetwork.{lin}.weight", "ffnetwork.{lin}.kernel", _T),
    ("ffnetwork.{lin}.bias", "ffnetwork.{lin}.bias", _SAME),
    ("ln_{n}.{p}", "ln_{n}.{p}", _SAME))
# one nn.Linear (the supervised criteria's)
_LINEAR = (("weight", "kernel", _T), ("bias", "bias", _SAME))

Rules = Sequence[Tuple[str, str, Tuple[Any, Any]]]


@functools.lru_cache(maxsize=None)
def _pattern(key: str) -> "re.Pattern":
    parts = re.split(r"\{(\w+)\}", key)
    return re.compile("".join(
        re.escape(p) if i % 2 == 0 else
        f"(?P<{p}>(?:[^.]+\\.)*)" if p == "path" else f"(?P<{p}>[^.]+?)"
        for i, p in enumerate(parts)))


def _relayout(sd: Dict[str, Any], rules: Rules, export: bool = False
              ) -> Dict[str, Any]:
    """``sd`` under the port's keys and layouts (``export``: from the
    port's to the other layout's), by the first rule whose key matches;
    keys no rule matches are left out."""
    out = {}
    for key, value in sd.items():
        for other, port, (to_port, back) in rules:
            src, dst, fn = (port, other, back) if export else \
                (other, port, to_port)
            m = _pattern(src).fullmatch(key)
            if m:
                out[dst.format(**m.groupdict())] = fn(value)
                break
    return out


# ---------------------------------------------------------------------------
# JAX parameter trees <-> the port's state dicts
# ---------------------------------------------------------------------------

def _flatten(tree: Dict[str, Any], prefix: str = ""
             ) -> Iterator[Tuple[str, np.ndarray]]:
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", np.asarray(value)


def port_leaves(tree: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """A JAX tree's leaves (a parameter or an optimizer moment tree) under
    the port's flat names and layouts, as numpy arrays."""
    return _relayout(dict(_flatten(tree)), _JAX)


def params_from_jax(jax_params: Dict[str, Any]) -> StateDict:
    """Flat state dict (``model.*``, ``criterion.*``) of the port."""
    # copy: never alias the caller's (possibly device-backed) buffers
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in port_leaves(jax_params).items()}


def jax_tree(state_dict: StateDict) -> Dict[str, Any]:
    """The inverse of :func:`params_from_jax`: a flat state dict of the
    port (any prefix) -> the JAX package's nested tree of float32 numpy
    leaves."""
    tree: Dict[str, Any] = {}
    flat = {k: v.detach().float().cpu().numpy()
            for k, v in state_dict.items()}
    for key, value in _relayout(flat, _JAX, export=True).items():
        parts = key.split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.ascontiguousarray(value)
    return tree


def load_jax_params(model: torch.nn.Module, criterion: torch.nn.Module,
                    jax_params: Dict[str, Any]) -> None:
    """Load the JAX parameter tree into ``model`` and ``criterion``
    (strict: every parameter of both must be present)."""
    sd = params_from_jax(jax_params)
    for prefix, module in (("model.", model), ("criterion.", criterion)):
        module.load_state_dict(_strip(sd, prefix))


def _strip(sd: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


# ---------------------------------------------------------------------------
# Reference state dicts <-> the port's
# ---------------------------------------------------------------------------

def _tensor(x) -> torch.Tensor:
    """A float32 CPU copy (never aliasing the source)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).clone()
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _reference(sd: Dict[str, Any], rules: Rules, export: bool = False
               ) -> StateDict:
    """:func:`_relayout` of a reference (or, with ``export``, the port's)
    state dict, as contiguous float32 CPU copies."""
    return {k: v.contiguous() for k, v in _relayout(
        {k: _tensor(v) for k, v in sd.items()}, rules, export).items()}


def _refuse_batch_norm(sd: Dict[str, Any], config: CPCConfig) -> None:
    if config.normMode != "layerNorm" or any(
            "running_mean" in k or "running_var" in k for k in sd):
        raise NotImplementedError(f"normMode={config.normMode!r} (and "
                                  f"batchNorm statistics) {_NOT_PORTED}")


def _ar_rules(sd: Dict[str, Any], config: CPCConfig, export: bool = False
              ) -> Rules:
    """The AR's table: ``_RECURRENT``, or the transformer's layers, each
    ``_TRANSFORMER_LAYER`` at nn.Sequential index i + 1 after the optional
    position embedding (abspos) and at the port's ``layer{i}``; the layer
    count is the state dict's (reference checkpoints hold one layer
    whatever nLevelsGRU says)."""
    if config.arMode == "no_ar":
        return ()
    if config.arMode != "transformer":
        return _RECURRENT
    offset = 1 if config.abspos else 0
    heads = {k.split(".")[0] for k in sd}
    layers = sorted(int(h[5:]) for h in heads if h.startswith("layer")) \
        if export else sorted(int(h) - offset for h in heads
                              if h.isdigit() and int(h) >= offset)
    return tuple((f"{i + offset}.{other}", f"layer{i}.{port}", fns)
                 for i in layers for other, port, fns in _TRANSFORMER_LAYER)


def convert_encoder(sd: Dict[str, Any], config: CPCConfig) -> StateDict:
    """gEncoder.* reference keys (prefix stripped) -> the port's CPCEncoder
    state dict: ``conv{i}.{weight,bias}`` as they are, the ChannelNorm's
    ``batchNorm{i}.{weight,bias}`` (1, C, 1) -> ``norm{i}.*`` (C,)."""
    if config.encoder_type != "cpc":
        raise NotImplementedError(f"encoder_type={config.encoder_type!r} "
                                  f"{_NOT_PORTED}")
    _refuse_batch_norm(sd, config)
    return _reference(sd, _ENCODER)


def convert_ar(sd: Dict[str, Any], config: CPCConfig) -> StateDict:
    """gAR.* reference keys (prefix stripped) -> the port's AR state dict:
    ``baseNet.{weight,bias}_{ih,hh}_l{l}`` -> ``layer{l}.*`` (same
    layout), or the transformer's ``{i}.*`` (after the optional position
    embedding) -> ``layer{i}.*``."""
    if any(k.startswith(("netForward.", "netBackward.", "ARNet."))
           for k in sd):
        raise NotImplementedError(f"the bidirectional ARs {_NOT_PORTED}")
    return _reference(sd, _ar_rules(sd, config))


def convert_cpc_model(state_dict: Dict[str, Any], config: CPCConfig
                      ) -> StateDict:
    """A whole reference CPCModel state dict (``ckpt["gEncoder"]``) -> the
    port's CPCModel state dict."""
    out = {f"gEncoder.{k}": v for k, v in convert_encoder(
        _strip(state_dict, "gEncoder."), config).items()}
    out.update({f"gAR.{k}": v for k, v in convert_ar(
        _strip(state_dict, "gAR."), config).items()})
    return out


def export_cpc_model(model: Union[torch.nn.Module, StateDict],
                     config: CPCConfig) -> StateDict:
    """The port's CPCModel (or its state dict) -> a state dict the
    reference's ``CPCModel.load_state_dict`` accepts (keys ``gEncoder.*`` /
    ``gAR.*``), float32 on the CPU: the inverse of
    :func:`convert_cpc_model`."""
    sd = model.state_dict() if isinstance(model, torch.nn.Module) else model
    ar = _strip(sd, "gAR.")
    out = {f"gEncoder.{k}": v for k, v in _reference(
        _strip(sd, "gEncoder."), _ENCODER, export=True).items()}
    out.update({f"gAR.{k}": v for k, v in _reference(
        ar, _ar_rules(ar, config, export=True), export=True).items()})
    return out


def convert_prediction_network(sd: Dict[str, Any], config: CPCConfig
                               ) -> StateDict:
    """``wPrediction.predictors.{k}.*`` (prefix ``wPrediction.`` stripped)
    -> the port's K-stacked ``heads.layer0.*``."""
    if config.rnnMode != "transformer":
        raise NotImplementedError(f"rnnMode={config.rnnMode!r} heads "
                                  f"{_NOT_PORTED}")
    heads = [_reference(_strip(sd, f"predictors.{k}.0."), _TRANSFORMER_LAYER)
             for k in range(config.nPredicts)]
    return {f"heads.layer0.{name}": torch.stack([h[name] for h in heads])
            for name in heads[0]}


def convert_criterion(state_dict: Dict[str, Any], config: CPCConfig,
                      kind: str = "cpc") -> StateDict:
    """A reference criterion state dict (``ckpt["cpcCriterion"]``) -> the
    port's, for ``kind`` cpc (transformer heads), speaker, phone (one
    classifier, or the multi-layer ``PhoneCriterionClassifier.{0,2,..}``)
    or ctc."""
    out: StateDict = {}

    def linear(name, prefix):
        out.update({f"{name}.{k}": v for k, v in _reference(
            _strip(state_dict, f"{prefix}."), _LINEAR).items()})

    if kind == "cpc":
        if "speakerEmb.weight" in state_dict:
            raise NotImplementedError(f"speakerEmbedding {_NOT_PORTED}")
        out.update({f"wPrediction.{k}": v for k, v in
                    convert_prediction_network(
                        _strip(state_dict, "wPrediction."), config).items()})
    elif kind == "speaker":
        linear("linearSpeakerClassifier", "linearSpeakerClassifier")
    elif kind == "phone":
        if "PhoneCriterionClassifier.weight" in state_dict:
            linear("classifier0", "PhoneCriterionClassifier")
        else:      # nn.Sequential(Linear, ReLU, Linear, ...): 0, 2, 4, ...
            i = 0
            while f"PhoneCriterionClassifier.{i}.weight" in state_dict:
                linear(f"classifier{i // 2}", f"PhoneCriterionClassifier.{i}")
                i += 2
    elif kind == "ctc":
        linear("PhoneCriterionClassifier", "PhoneCriterionClassifier")
    else:
        raise ValueError(f"unknown criterion kind {kind!r}")
    return out


# ---------------------------------------------------------------------------
# Any checkpoint format -> the port's state dicts and TrainState
# ---------------------------------------------------------------------------

def _refuse_batch_stats(data: Dict[str, Any]) -> None:
    if data.get("batch_stats"):
        raise NotImplementedError(f"batchNorm statistics {_NOT_PORTED}")


def model_state_dict(data: Dict[str, Any], config: CPCConfig) -> StateDict:
    """The port's model state dict from ``data["gEncoder"]`` of a
    checkpoint of any format (checkpoint.load_checkpoint)."""
    fmt = data.get("format")
    if fmt == ckpt.FORMAT:
        return dict(data["gEncoder"])
    if fmt == ckpt.JAX_FORMAT:
        _refuse_batch_stats(data)
        return _strip(params_from_jax({"model": data["gEncoder"]}),
                      "model.")
    return convert_cpc_model(dict(data["gEncoder"]), config)


def criterion_state_dict(data: Dict[str, Any], config: CPCConfig,
                         kind: str = "cpc") -> StateDict:
    """The port's criterion state dict from ``data["cpcCriterion"]`` of a
    checkpoint of any format; ``kind`` names a reference criterion's
    layout (:func:`convert_criterion`)."""
    fmt = data.get("format")
    if fmt == ckpt.FORMAT:
        return dict(data["cpcCriterion"])
    if fmt == ckpt.JAX_FORMAT:
        return _strip(params_from_jax(
            {"criterion": data["cpcCriterion"]}), "criterion.")
    return convert_criterion(dict(data["cpcCriterion"]), config, kind)


def _adam_moments(optimizer: torch.optim.Adam, named: dict,
                  opt_state) -> bool:
    """Put the JAX package's optax Adam state ``((count, mu, nu), ())``
    into ``optimizer`` for the parameters ``named`` (``model.*`` /
    ``criterion.*``); False, and nothing changed, where a moment is
    missing or its shape or dtype differs from the parameter's."""
    try:
        (count, mu, nu), _ = opt_state
        moments = [port_leaves(mu), port_leaves(nu)]
    except (TypeError, ValueError):
        return False
    for name, p in named.items():
        for flat in moments:
            m = flat.get(name)
            if m is None or tuple(m.shape) != tuple(p.shape) \
                    or str(m.dtype) != str(p.dtype).replace("torch.", ""):
                return False
    if set(moments[0]) != set(named):
        return False
    group = optimizer.param_groups[0]
    on_device = group.get("capturable") or group.get("fused")
    for name, p in named.items():
        optimizer.state[p] = {
            "step": torch.tensor(float(np.asarray(count)),
                                 dtype=torch.float32,
                                 device=p.device if on_device else "cpu"),
            "exp_avg": torch.from_numpy(np.array(moments[0][name])).to(
                p.device),
            "exp_avg_sq": torch.from_numpy(np.array(moments[1][name])).to(
                p.device)}
    return True


def load_state_into(state, path: str, config: CPCConfig,
                    load_criterion: bool = False,
                    load_optimizer: bool = False) -> None:
    """Load checkpoint ``path`` (any format) into a trainer's ``TrainState``
    in place (cpc_audio_tpu/feature_loader.py:138-199): the model; the
    criterion with ``load_criterion``; with ``load_optimizer`` the Adam
    moments and step count of a checkpoint of the port or the JAX package
    (a reference torch checkpoint carries none), where their shapes and
    dtypes match the parameters', else they stay new, with a warning."""
    data = ckpt.load_checkpoint(path)
    fmt = data["format"]
    try:
        state.model.load_state_dict(model_state_dict(data, config))
        if load_criterion and data.get("cpcCriterion"):
            state.criterion.load_state_dict(
                criterion_state_dict(data, config, kind="cpc"))
    except RuntimeError as e:
        raise ValueError(f"checkpoint {path} does not match the model: "
                         f"{e}") from e
    if not load_optimizer or fmt == "torch" or data.get("optimizer") is None:
        return
    if fmt == ckpt.FORMAT:
        state.optimizer.load_state_dict(data["optimizer"])
        for group in state.optimizer.param_groups:
            group["lr"] = state.lr      # keep the one device lr tensor
        state.step.fill_(data["step"])
        return
    named = {f"{prefix}.{n}": p for prefix, mod in
             (("model", state.model), ("criterion", state.criterion))
             for n, p in mod.named_parameters()}
    if _adam_moments(state.optimizer, named, data["optimizer"]):
        state.step.fill_(int(np.asarray(data["optimizer"][0][0])))
    else:
        print("WARNING: optimizer state incompatible; reinitialized")


# ---------------------------------------------------------------------------
# Reference-format files
# ---------------------------------------------------------------------------

def export_torch_checkpoint(model: Union[torch.nn.Module, StateDict],
                            config: CPCConfig, path: str,
                            criterion_params: Optional[dict] = None
                            ) -> None:
    """Write a reference-format torch checkpoint (``gEncoder``,
    ``cpcCriterion``, ``optimizer``, ``best``) that the reference's
    loadModel reads.  ``cpcCriterion`` is ``criterion_params or {}``, as
    the JAX package writes it (its trainer passes no criterion)."""
    state = {"gEncoder": export_cpc_model(model, config),
             "cpcCriterion": criterion_params or {},
             "optimizer": {}, "best": {}}
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def export_checkpoint_file(path_in: str, path_out: str,
                           path_args: Optional[str] = None) -> None:
    """Convert a trainer checkpoint (the port's, or the JAX package's
    pickle) into a reference-format torch checkpoint; the config comes
    from ``path_args`` (default: the ``checkpoint_args.json`` beside
    ``path_in``)."""
    data = ckpt.load_checkpoint(path_in)
    if path_args is None:
        path_args = os.path.join(os.path.dirname(path_in) or ".",
                                 "checkpoint_args.json")
    with open(path_args) as f:
        config = CPCConfig.from_dict(json.load(f))
    if config.arMode in ("no_ar", "transformer"):
        config = config.replace(hiddenGar=config.hiddenEncoder)
    export_torch_checkpoint(model_state_dict(data, config), config, path_out)


def main(argv=None) -> int:
    """CLI: ``python -m cpc_audio_tpu_torch.convert export <in.pt>
    <out.pt> [--path_args <checkpoint_args.json>]``."""
    import argparse

    parser = argparse.ArgumentParser(
        description="Checkpoint format conversion")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("export", help="trainer checkpoint -> reference "
                                      "torch format")
    p.add_argument("checkpoint", type=str)
    p.add_argument("output", type=str)
    p.add_argument("--path_args", type=str, default=None,
                   help="checkpoint_args.json (default: sibling of input)")
    args = parser.parse_args(argv)
    export_checkpoint_file(args.checkpoint, args.output, args.path_args)
    print(f"Exported {args.checkpoint} -> {args.output} (torch format)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
