"""The port's train path for the ``--arMode``s GRU, transformer, RNN and
no_ar against the JAX package: one ``make_train_step`` step of each on
the same weights, batch and Feistel round keys (float32 on the CPU,
dropout off in both), and the train CLI on the CPU for GRU and
transformer, with a carried state under sequential sampling."""

import functools
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cpc_audio_tpu.config import CPCConfig, TrainConfig
from cpc_audio_tpu.criterion import infonce as jinfonce
from cpc_audio_tpu.criterion import stacked_heads as jstacked
from cpc_audio_tpu.models import build_model as jbuild_model
from cpc_audio_tpu.models import transformer as jtransformer
from cpc_audio_tpu.parallel import get_mesh, shard_batch
from cpc_audio_tpu.parallel.train_step import TrainState as JTrainState
from cpc_audio_tpu.parallel.train_step import make_optimizer as jopt
from cpc_audio_tpu.parallel.train_step import \
    make_train_step as jmake_train_step
from cpc_audio_tpu.train import get_criterion
from cpc_audio_tpu_torch import config as tconfig
from cpc_audio_tpu_torch import train as ttrain
from cpc_audio_tpu_torch.convert import load_jax_params, params_from_jax
from cpc_audio_tpu_torch.criterion import build_criterion
from cpc_audio_tpu_torch.models import build_model
from cpc_audio_tpu_torch.parallel.train_step import (create_train_state,
                                                     make_train_step)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# S = 32 frames, B*S = 64 and 16 negatives resolve `auto` to the stratified
# sampler; D = 32 (8 heads of dk = 4 in the heads and the transformer AR)
B = 2
KEYS = np.array([0x12345678, 0x9ABCDEF0, 0x0F1E2D3C, 0xDEADBEEF, 0x2468ACE0],
                np.uint32)


def _config(ar_mode):
    return CPCConfig(hiddenEncoder=32, hiddenGar=32, nPredicts=4,
                     negativeSamplingExt=16, sizeWindow=5120, arMode=ar_mode)


def _waves(batch, n, seed):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16000.0
    f0 = rng.uniform(100, 400, size=(batch, 1))
    x = 0.3 * np.sin(2 * np.pi * f0 * t) + 0.05 * rng.randn(batch, n)
    return x[:, None, :].astype(np.float32)


def _flat(tree):
    return {k: v.numpy() for k, v in params_from_jax(tree).items()}


@pytest.mark.parametrize("ar_mode", ["GRU", "transformer", "RNN", "no_ar"])
def test_train_step_matches_jax(ar_mode, monkeypatch):
    """Losses, accuracies and every gradient leaf of one step.  Dropout
    is patched to 0 in the JAX heads and transformer layers here only,
    and set to 0 in the port's; the round keys are injected into the JAX
    sampler as tests/test_torch_train.py does."""
    monkeypatch.setattr(jstacked, "StackedTransformerHeads",
                        functools.partial(jstacked.StackedTransformerHeads,
                                          dropout=0.0))
    monkeypatch.setattr(jtransformer, "TransformerLayer",
                        functools.partial(jtransformer.TransformerLayer,
                                          dropout=0.0))
    for fn in ("feistel_permute", "feistel_inverse"):
        orig = getattr(jinfonce, fn)
        monkeypatch.setattr(jinfonce, fn, lambda x, _k, n, orig=orig: orig(
            x, jnp.asarray(KEYS), n))
    cfg = _config(ar_mode)
    jmodel = jbuild_model(cfg)
    jcrit = get_criterion(cfg, TrainConfig(), 160, 0, 0)
    x = _waves(B, cfg.sizeWindow, 4)
    params = {"model": jax.jit(jmodel.init)(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(x))["params"]}
    c, z, _, _ = jmodel.apply({"params": params["model"]}, jnp.asarray(x))
    params["criterion"] = jax.jit(
        lambda rngs, c, z: jcrit.init(rngs, c, z, None))(
        {"params": jax.random.PRNGKey(1),
         "sampling": jax.random.PRNGKey(2)}, c, z)["params"]
    optimizer = jopt(cfg.beta1, cfg.beta2, cfg.epsilon)
    state0 = JTrainState(params, {}, optimizer.init(params),
                         jnp.zeros((), jnp.int32))
    mesh = get_mesh(1)
    jstep = jmake_train_step(jmodel, jcrit, optimizer, mesh, donate=False)
    state1, _, metrics_j = jstep(state0, shard_batch(mesh, x), None, None,
                                 jax.random.PRNGKey(7), 2e-4)
    # optax's first moment after one step is (1 - beta1) * grad
    grads_j = _flat(jax.tree_util.tree_map(
        lambda m: np.asarray(m) / (1.0 - cfg.beta1), state1.opt_state[0].mu))

    tcfg = tconfig.CPCConfig(**cfg.to_dict())
    model, crit = build_model(tcfg), build_criterion(tcfg)
    load_jax_params(model, crit, params)
    crit.wPrediction.heads.dropout = 0.0
    if ar_mode == "transformer":
        model.gAR.dropout = 0.0
    state = create_train_state(model, crit, "cpu", 2e-4)
    _, metrics = make_train_step(state, "cpu")(
        x, round_keys=torch.from_numpy(KEYS.astype(np.int64)))
    grads = {prefix + name: p.grad.numpy()
             for prefix, module in (("model.", model), ("criterion.", crit))
             for name, p in module.named_parameters()}
    assert sorted(grads) == sorted(grads_j)

    # f32 throughout; sums in another order
    np.testing.assert_allclose(metrics["losses"].numpy(),
                               np.asarray(metrics_j["losses"]), atol=1e-5)
    W = cfg.sizeWindow // 160 - cfg.nPredicts
    np.testing.assert_allclose(metrics["acc"].numpy(),
                               np.asarray(metrics_j["acc"]),
                               atol=1.0 / (B * W) + 1e-7)
    for name, g in grads.items():
        # each leaf within 1e-3 of its largest entry: float32 sums taken
        # in another order through the AR and the 2048-wide FFNs
        w = grads_j[name]
        err = np.abs(g - w).max()
        assert err <= 1e-3 * np.abs(w).max() + 1e-8, (name, err)


@pytest.mark.parametrize("ar_mode", ["GRU", "transformer"])
def test_train_cli_runs_each_ar_mode(ar_mode, tmp_path, capsys):
    """One epoch on the CPU (device="cpu") under sequential sampling: the
    GRU carries its (layers, B, H) state from batch to batch, the
    transformer carries none."""
    sys.path.insert(0, os.path.join(REPO, "perf"))
    from soak_loader import make_tree
    root, out = str(tmp_path / "db"), str(tmp_path / "ckpt")
    make_tree(root, 8, 2, min_s=1.0, max_s=1.5, tone=True, quiet=True)
    argv = ["--pathDB", root, "--file_extension", ".wav",
            "--pathCheckpoint", out, "--hiddenEncoder", "32",
            "--hiddenGar", "64", "--nPredicts", "2",
            "--negativeSamplingExt", "4", "--sizeWindow", "5120",
            "--batchSizeGPU", "4", "--nEpoch", "1", "--n_process_loader",
            "1", "--ignore_cache", "--random_seed", "3", "--arMode", ar_mode,
            "--samplingType", "sequential"]
    if ar_mode == "GRU":
        argv += ["--hiddenGar", "32", "--nLevelsGRU", "2"]
    assert ttrain.main(argv, device="cpu") == 0
    assert sorted(os.listdir(out)) == ["checkpoint_0.pt",
                                       "checkpoint_args.json",
                                       "checkpoint_logs.json"]
    with open(os.path.join(out, "checkpoint_logs.json")) as f:
        logs = json.load(f)
    assert logs["epoch"] == [0]
    assert all(np.isfinite(v).all() for v in logs["locLoss_train"])
    with open(os.path.join(out, "checkpoint_args.json")) as f:
        args = json.load(f)
    # no_ar / transformer size the criterion to hiddenEncoder
    assert args["arMode"] == ar_mode and args["hiddenGar"] == 32
    assert "Average training loss on epoch" in capsys.readouterr().out
