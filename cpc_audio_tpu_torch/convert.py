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

* encoder conv kernels (the LFB encoder's ``conv`` too), stored (W, in,
  out) ('WIO'), become torch's (out, in, W) ``weight``;
* the recurrent layers' ``weight_ih_t (C, G*H)`` / ``weight_hh_t (H,
  G*H)`` (LSTM G = 4, GRU G = 3, RNN G = 1) become torch's ``weight_ih
  (G*H, C)`` / ``weight_hh (G*H, H)``: the ARs' ``layer{l}``, the
  bidirectional ARs' ``layer{l}_fwd`` / ``_bwd`` and ``netForward`` /
  ``netBackward`` stacks, and the Common Voice CTC head's LSTM
  (``conv1``); the K-stacked RNN and LSTM prediction heads'
  ``heads.cell.weight_*_t (K, in, out)`` transpose their last two axes;
* everything else keeps its name and shape: the rest of the K-stacked
  head tree, the transformer AR's
  ``gAR.layer0.multihead.{Wq,Wk,Wv,Wo}.kernel``, ``multihead.Krelpos``,
  ``ffnetwork.lin{1,2}.{kernel,bias}`` and ``ln_*``, whose ``(in, out)``
  kernel layout the port keeps (models/transformer.py), the supervised
  criteria's ``(in, out)`` ``kernel`` and ``bias``, the speaker
  embedding's ``speakerEmb.embedding``, and flax BatchNorm's ``scale`` /
  ``bias``.

flax BatchNorm's running statistics live in the separate ``batch_stats``
collection (``TrainState.batch_stats``, ``{"model": {"gEncoder":
{"norm{i}": {"mean", "var"}}}}``); the port keeps them as the buffers
``mean`` / ``var`` of its BatchNorm (models/norms.py), under the same
names: ``load_jax_params`` takes them beside the parameters, and
``jax_tree`` / ``jax_batch_stats`` split a state dict back into the two
trees.

The mapping is leaf by leaf, so an optimizer moment tree of the same
structure maps through it the same way (``load_state_into``);
``jax_tree`` is its inverse.

**Reference state dicts** (``gEncoder.*`` / ``gAR.*`` of a CPCModel, the
``cpcCriterion`` of the reference trainer; ``_NORMS``, ``_RECURRENT``,
``_HEADS``, ``_TRANSFORMER_LAYER``, ``_LINEAR``).  ``convert_cpc_model`` and
``convert_criterion`` read them into the port's state dicts;
``export_cpc_model``, ``export_torch_checkpoint`` and
``export_checkpoint_file`` (the CLI ``python -m cpc_audio_tpu_torch.convert
export <in> <out>``) write them.  Every linear and attention weight is
(out, in) there and transposes to the port's (in, out) ``kernel``; conv
and recurrent weights keep their torch layouts.  The encoder's table
follows ``--encoder_type`` and ``--normMode`` (:func:`_encoder_rules`:
ChannelNorm's (1, C, 1) affine, InstanceNorm's (C,), BatchNorm's weight,
bias and running statistics, LFB's ``conv``); the heads' follows
``--rnnMode`` (:func:`_head_rules`), each head's ``predictors.{k}.*``
stacked on K; ``speakerEmb.weight`` is the embedding table.  The
bidirectional ARs, which no ``--arMode`` builds, convert alone
(:func:`convert_bidir_tangled`, :func:`convert_bidir`).
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

StateDict = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# The layout tables
# ---------------------------------------------------------------------------

def _same(x):
    return x


_SAME = (_same, _same)
_T = (lambda x: x.T, lambda x: x.T)
# K-stacked (K, in, out) <-> (K, out, in): the last two axes only
_T_STACKED = (lambda x: np.swapaxes(x, -1, -2),) * 2
# conv kernels: the JAX package's (W, in, out) <-> torch's (out, in, W)
_WIO = (lambda x: np.transpose(x, (2, 1, 0)),) * 2
# ChannelNorm's affine: the reference's (1, C, 1) <-> the port's (C,)
_CHANNEL = (lambda x: x.reshape(-1), lambda x: x.reshape(1, -1, 1))

# the JAX package's leaves whose name or layout differ from the port's
_JAX = (("{path}gEncoder.conv{i}.kernel", "{path}gEncoder.conv{i}.weight",
         _WIO),
        # the LFB encoder's conv
        ("{path}gEncoder.conv.kernel", "{path}gEncoder.conv.weight", _WIO),
        # the recurrent ARs' layers (layer{l}, layer{l}_fwd / _bwd)
        ("{path}layer{l}.weight_{g}_t", "{path}layer{l}.weight_{g}", _T),
        # the K-stacked RNN / LSTM prediction heads
        ("{path}heads.cell.weight_{g}_t", "{path}heads.cell.weight_{g}",
         _T_STACKED),
        # the Common Voice CTC head's LSTM (eval/common_voices.py)
        ("{path}conv1.weight_{g}_t", "{path}conv1.weight_{g}", _T),
        ("{path}{leaf}", "{path}{leaf}", _SAME))

# the reference's encoder norms (gEncoder.batchNorm{i}.*) by --normMode:
# ChannelNorm's affine is (1, C, 1), InstanceNorm's and BatchNorm's (C,)
_NORMS = {
    "layerNorm": (("batchNorm{i}.{p}", "norm{i}.{p}", _CHANNEL),),
    "instanceNorm": (("batchNorm{i}.{p}", "norm{i}.{p}", _SAME),),
    "batchNorm": (("batchNorm{i}.weight", "norm{i}.scale", _SAME),
                  ("batchNorm{i}.bias", "norm{i}.bias", _SAME),
                  ("batchNorm{i}.running_mean", "norm{i}.mean", _SAME),
                  ("batchNorm{i}.running_var", "norm{i}.var", _SAME)),
    "ID": ()}
# the reference's nn.LSTM / GRU / RNN AR (gAR.*)
_RECURRENT = (("baseNet.{p}_{g}_l{l}", "layer{l}.{p}_{g}", _SAME),)
# the reference's BiDIRARTangled (one bidirectional nn.GRU, ARNet) and
# BiDIRAR (two nn.GRU stacks, netForward and netBackward)
_BIDIR_TANGLED = (("ARNet.{p}_{g}_l{l}_reverse", "layer{l}_bwd.{p}_{g}",
                   _SAME),
                  ("ARNet.{p}_{g}_l{l}", "layer{l}_fwd.{p}_{g}", _SAME))
_BIDIR = (("{net}.{p}_{g}_l{l}", "{net}.layer{l}.{p}_{g}", _SAME),)
# one reference TransformerLayer (the transformer AR's, a head's)
_TRANSFORMER_LAYER = (
    ("multihead.{w}.weight", "multihead.{w}.kernel", _T),
    ("multihead.Att.Krelpos", "multihead.Krelpos", _SAME),
    ("ffnetwork.{lin}.weight", "ffnetwork.{lin}.kernel", _T),
    ("ffnetwork.{lin}.bias", "ffnetwork.{lin}.bias", _SAME),
    ("ln_{n}.{p}", "ln_{n}.{p}", _SAME))
# one nn.Linear (the supervised criteria's)
_LINEAR = (("weight", "kernel", _T), ("bias", "bias", _SAME))
# one reference prediction head (predictors.{k}.*) by --rnnMode, under
# the port's heads.* names before the heads are stacked on K
_HEADS = {
    "transformer": tuple(("0." + other, "layer0." + port, fns)
                         for other, port, fns in _TRANSFORMER_LAYER),
    "linear": (("weight", "kernel", _T),),
    "ffd": (("{lin}.module.weight", "{lin}.kernel", _T),
            ("{lin}.module.bias", "{lin}.bias", _SAME)),
    "conv": (("module.module.{p}", "module.{p}", _SAME),),
    "recurrent": (("{p}_{g}_l0", "cell.{p}_{g}", _SAME),)}

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


def _batch_stat(key: str) -> bool:
    """A BatchNorm running statistic of the port (models/norms.py)."""
    return re.fullmatch(r"(?:.*\.)?norm\d+\.(?:mean|var)", key) is not None


def _nest(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.ascontiguousarray(value)
    return tree


def jax_tree(state_dict: StateDict) -> Dict[str, Any]:
    """The inverse of :func:`params_from_jax`: a flat state dict of the
    port (any prefix) -> the JAX package's nested parameter tree of
    float32 numpy leaves (BatchNorm's running statistics left out: see
    :func:`jax_batch_stats`)."""
    flat = {k: v.detach().float().cpu().numpy()
            for k, v in state_dict.items() if not _batch_stat(k)}
    return _nest(_relayout(flat, _JAX, export=True))


def jax_batch_stats(state_dict: StateDict) -> Dict[str, Any]:
    """BatchNorm's running statistics of a port state dict (any prefix) as
    the JAX package's ``batch_stats`` tree; {} where there are none."""
    return _nest({k: v.detach().float().cpu().numpy()
                  for k, v in state_dict.items() if _batch_stat(k)})


def load_jax_params(model: torch.nn.Module, criterion: torch.nn.Module,
                    jax_params: Dict[str, Any],
                    batch_stats: Optional[Dict[str, Any]] = None) -> None:
    """Load the JAX parameter tree into ``model`` and ``criterion``
    (strict: every parameter of both must be present), and BatchNorm's
    running statistics from ``batch_stats`` (``TrainState.batch_stats``,
    ``{"model": ...}``); without it the model keeps its own."""
    sd = params_from_jax(jax_params)
    model_sd = _strip(sd, "model.")
    model_sd.update(_stats_from_jax(batch_stats))
    params = dict(model.named_parameters())
    for k, v in model.state_dict().items():
        if k not in params:
            model_sd.setdefault(k, v)
    model.load_state_dict(model_sd)
    criterion.load_state_dict(_strip(sd, "criterion."))


def _stats_from_jax(batch_stats: Optional[Dict[str, Any]]) -> StateDict:
    """A JAX ``batch_stats`` tree, with or without its ``model`` level, as
    the port's model buffers."""
    stats = batch_stats or {}
    stats = stats.get("model", stats)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in _flatten(stats)}


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


def _encoder_rules(config: CPCConfig) -> Rules:
    """The encoder's table: LFB's ``conv``, none for MFCC; for the conv
    encoder its ``conv{i}`` and the norms of ``--normMode``."""
    if config.encoder_type == "lfb":
        return (("conv.{p}", "conv.{p}", _SAME),)
    if config.encoder_type == "mfcc":
        return ()
    return (("conv{i}.{p}", "conv{i}.{p}", _SAME),) + _NORMS[config.normMode]


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
    """gEncoder.* reference keys (prefix stripped) -> the port's encoder
    state dict (:func:`_encoder_rules`): ``conv{i}.{weight,bias}`` as they
    are, the norms' ``batchNorm{i}.*`` -> ``norm{i}.*`` (ChannelNorm's (1,
    C, 1) affine -> (C,); BatchNorm's weight, bias, running_mean and
    running_var -> scale, bias, mean and var), or the LFB's ``conv``."""
    return _reference(sd, _encoder_rules(config))


def convert_ar(sd: Dict[str, Any], config: CPCConfig) -> StateDict:
    """gAR.* reference keys (prefix stripped) -> the port's AR state dict:
    ``baseNet.{weight,bias}_{ih,hh}_l{l}`` -> ``layer{l}.*`` (same
    layout), or the transformer's ``{i}.*`` (after the optional position
    embedding) -> ``layer{i}.*``.  The bidirectional ARs' keys raise: no
    ``--arMode`` builds them, in either package (convert them alone with
    :func:`convert_bidir_tangled` / :func:`convert_bidir`)."""
    if any(k.startswith(("netForward.", "netBackward.", "ARNet."))
           for k in sd):
        raise ValueError("a bidirectional AR (netForward / netBackward / "
                         "ARNet keys) is no CPCModel's AR: no --arMode "
                         "builds one, in either package")
    return _reference(sd, _ar_rules(sd, config))


def convert_bidir_tangled(sd: Dict[str, Any]) -> StateDict:
    """The reference's BiDIRARTangled state dict (one ``nn.GRU(
    bidirectional=True)``, ``ARNet.*``) -> the port's BiDIRARTangled:
    ``ARNet.*_l{l}`` -> ``layer{l}_fwd.*``, ``ARNet.*_l{l}_reverse`` ->
    ``layer{l}_bwd.*`` (cpc_audio_tpu/convert.py:104-111)."""
    return _reference(sd, _BIDIR_TANGLED)


def convert_bidir(sd: Dict[str, Any]) -> StateDict:
    """The reference's BiDIRAR state dict (two ``nn.GRU`` stacks,
    ``netForward.*`` and ``netBackward.*``) -> the port's BiDIRAR:
    ``{net}.*_l{l}`` -> ``{net}.layer{l}.*`` (cpc_audio_tpu/convert.py
    :114-120)."""
    return _reference(sd, _BIDIR)


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
        _strip(sd, "gEncoder."), _encoder_rules(config), export=True).items()}
    out.update({f"gAR.{k}": v for k, v in _reference(
        ar, _ar_rules(ar, config, export=True), export=True).items()})
    return out


def _head_rules(rnn_mode: str) -> Rules:
    """One reference head's table for ``--rnnMode`` (any other value
    builds linear heads, as in both packages)."""
    if rnn_mode in ("RNN", "LSTM"):
        return _HEADS["recurrent"]
    if rnn_mode and rnn_mode.startswith("conv"):
        return _HEADS["conv"]
    return _HEADS.get(rnn_mode, _HEADS["linear"])


def convert_prediction_network(sd: Dict[str, Any], config: CPCConfig
                               ) -> StateDict:
    """``wPrediction.predictors.{k}.*`` (prefix ``wPrediction.`` stripped)
    -> the port's K-stacked ``heads.*`` of ``--rnnMode`` (:func:`_head_rules`;
    cpc_audio_tpu/convert.py:186-231)."""
    rules = _head_rules(config.rnnMode)
    heads = [_reference(_strip(sd, f"predictors.{k}."), rules)
             for k in range(config.nPredicts)]
    return {f"heads.{name}": torch.stack([h[name] for h in heads])
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
            out["speakerEmb.embedding"] = _tensor(
                state_dict["speakerEmb.weight"])
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

def model_state_dict(data: Dict[str, Any], config: CPCConfig) -> StateDict:
    """The port's model state dict from ``data["gEncoder"]`` of a
    checkpoint of any format (checkpoint.load_checkpoint)."""
    fmt = data.get("format")
    if fmt == ckpt.FORMAT:
        return dict(data["gEncoder"])
    if fmt == ckpt.JAX_FORMAT:
        # the pickle's batch_stats: TrainState.batch_stats, {"model": ...}
        return {**_strip(params_from_jax({"model": data["gEncoder"]}),
                         "model."),
                **_stats_from_jax(data.get("batch_stats"))}
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
