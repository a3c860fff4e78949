"""Checkpoint interchange between the port (cpc_audio_tpu_torch), the JAX
package and the reference torch layout, on the CPU in float32: the port
loads the JAX package's pickles and reference-format exports, its exports
load back into the JAX package leaf by leaf, and its trainer takes
``--load`` of a JAX checkpoint and ``--export_torch``."""

import functools
import json
import os
import pickle
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cpc_audio_tpu import checkpoint as jckpt
from cpc_audio_tpu import convert as jconvert
from cpc_audio_tpu import feature_loader as jfl
from cpc_audio_tpu.config import CPCConfig as JCPCConfig
from cpc_audio_tpu.config import TrainConfig
from cpc_audio_tpu.criterion import infonce as jinfonce
from cpc_audio_tpu.criterion import stacked_heads as jstacked
from cpc_audio_tpu.models import build_model as jbuild_model
from cpc_audio_tpu.parallel import get_mesh, shard_batch
from cpc_audio_tpu.parallel.train_step import TrainState as JTrainState
from cpc_audio_tpu.parallel.train_step import make_optimizer as jopt
from cpc_audio_tpu.parallel.train_step import \
    make_train_step as jmake_train_step
from cpc_audio_tpu.train import get_criterion as jget_criterion
from cpc_audio_tpu_torch import checkpoint as tckpt
from cpc_audio_tpu_torch import convert as tconvert
from cpc_audio_tpu_torch import train as ttrain
from cpc_audio_tpu_torch.config import CPCConfig
from cpc_audio_tpu_torch.criterion import build_criterion
from cpc_audio_tpu_torch.feature_loader import load_model, load_state_into
from cpc_audio_tpu_torch.models import ConcatenatedModel, build_model
from cpc_audio_tpu_torch.parallel.train_step import (create_train_state,
                                                     make_train_step)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(hiddenEncoder=32, hiddenGar=32, nPredicts=2,
             negativeSamplingExt=4, sizeWindow=3200)
KEYS = np.array([0x12345678, 0x9ABCDEF0, 0x0F1E2D3C, 0xDEADBEEF, 0x2468ACE0],
                np.uint32)


def _waves(batch, n, seed):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16000.0
    f0 = rng.uniform(100, 400, size=(batch, 1))
    x = 0.3 * np.sin(2 * np.pi * f0 * t) + 0.05 * rng.randn(batch, n)
    return x[:, None, :].astype(np.float32)


def _jax_run(run_dir, cfg, seed=0, criterion=None, opt_state=None,
             train_config=None, params=None):
    """A JAX-format run directory: checkpoint_0.pt (pickle) and its
    sidecar; returns (JAX model, model params)."""
    os.makedirs(run_dir, exist_ok=True)
    jmodel = jbuild_model(cfg)
    if params is None:
        params = jmodel.init({"params": jax.random.PRNGKey(seed)},
                             jnp.zeros((1, 1, cfg.sizeWindow)))["params"]
    jckpt.save_checkpoint(params, criterion or {}, opt_state or {}, params,
                          os.path.join(run_dir, "checkpoint_0.pt"))
    jckpt.save_args_sidecar(run_dir, cfg, train_config)
    return jmodel, params


def _jax_forward(jmodel, params, x):
    c, z, _, _ = jmodel.apply({"params": params}, jnp.asarray(x))
    return np.asarray(c), np.asarray(z)


def _port_forward(model, x):
    with torch.no_grad():
        c, z, _, _ = model(torch.from_numpy(x))
    return c.numpy(), z.numpy()


@pytest.mark.parametrize("ar_mode", ["LSTM", "GRU", "transformer"])
def test_jax_checkpoints_load_in_the_port(tmp_path, ar_mode):
    """The JAX package's pickle and its reference-format export
    (export_torch_checkpoint) of the same weights give the JAX forward's c
    and z through the port's load_model."""
    cfg = JCPCConfig(arMode=ar_mode, **SMALL)
    run = str(tmp_path / "run")
    jmodel, params = _jax_run(run, cfg, seed=1)
    exported = os.path.join(run, "checkpoint_0.torch.pt")
    jconvert.export_torch_checkpoint(params, cfg, exported)
    x = _waves(2, cfg.sizeWindow, 3)
    want_c, want_z = _jax_forward(jmodel, params, x)
    for path, fmt in ((os.path.join(run, "checkpoint_0.pt"),
                       tckpt.JAX_FORMAT), (exported, "torch")):
        assert tckpt.load_checkpoint(path)["format"] == fmt
        model, hg, he = load_model([path], device="cpu")
        assert (hg, he) == (32, 32) and not model.training
        c, z = _port_forward(model, x)
        np.testing.assert_allclose(c, want_c, atol=1e-5, err_msg=fmt)
        np.testing.assert_allclose(z, want_z, atol=1e-5, err_msg=fmt)


@pytest.mark.parametrize("ar_mode", ["LSTM", "transformer"])
def test_port_export_round_trips_through_jax_convert(ar_mode):
    """Port export_cpc_model -> JAX convert_cpc_model gives back the JAX
    tree of the port's weights exactly, with JAX export_cpc_model's keys;
    JAX export_cpc_model -> port convert_cpc_model gives the port's state
    dict exactly."""
    cfg = CPCConfig(arMode=ar_mode, **SMALL)
    model = build_model(cfg, torch.Generator().manual_seed(4))
    cfg = model.config
    jcfg = JCPCConfig(**cfg.to_dict())
    sd = model.state_dict()
    want = jax_tree = tconvert.jax_tree(sd)
    exported = tconvert.export_cpc_model(model, cfg)
    got, stats = jconvert.convert_cpc_model(exported, jcfg)
    assert not stats
    jax_keys = set(jconvert.export_cpc_model(jax_tree, jcfg))
    assert set(exported) == jax_keys
    flat_got = dict(tconvert._flatten(got))
    flat_want = dict(tconvert._flatten(want))
    assert sorted(flat_got) == sorted(flat_want)
    for k, v in flat_want.items():
        np.testing.assert_array_equal(flat_got[k], v, err_msg=k)
    back = tconvert.convert_cpc_model(
        jconvert.export_cpc_model(jax_tree, jcfg), cfg)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0, msg=k)


# the config of tests/test_torch_train.py's narrow step: `auto` resolves to
# the stratified sampler, whose Feistel keys are injected into both
CFG40 = dict(hiddenEncoder=40, hiddenGar=40, nPredicts=2,
             negativeSamplingExt=8, sizeWindow=2560)


def test_jax_pickle_resumes_in_the_port(tmp_path, monkeypatch):
    """A JAX checkpoint taken after one step (model, criterion and Adam
    moments) loaded by load_state_into: the port's next two steps give the
    JAX package's second and third step losses (the third depends on the
    moments carried over)."""
    monkeypatch.setattr(jstacked, "StackedTransformerHeads",
                        functools.partial(jstacked.StackedTransformerHeads,
                                          dropout=0.0))
    for fn in ("feistel_permute", "feistel_inverse"):
        orig = getattr(jinfonce, fn)
        monkeypatch.setattr(jinfonce, fn, lambda x, _k, n, orig=orig: orig(
            x, jnp.asarray(KEYS), n))
    jcfg = JCPCConfig(**CFG40)
    jmodel = jbuild_model(jcfg)
    jcrit = jget_criterion(jcfg, TrainConfig(), 160, 0, 0)
    x = _waves(2, jcfg.sizeWindow, 4)
    params = {"model": jmodel.init({"params": jax.random.PRNGKey(0)},
                                   jnp.asarray(x))["params"]}
    c, z, _, _ = jmodel.apply({"params": params["model"]}, jnp.asarray(x))
    params["criterion"] = jcrit.init(
        {"params": jax.random.PRNGKey(1), "sampling": jax.random.PRNGKey(2)},
        c, z, None)["params"]
    optimizer = jopt(jcfg.beta1, jcfg.beta2, jcfg.epsilon)
    state = JTrainState(params, {}, optimizer.init(params),
                        jnp.zeros((), jnp.int32))
    mesh = get_mesh(1)
    jstep = jmake_train_step(jmodel, jcrit, optimizer, mesh, donate=False)
    losses_j = []
    for i in range(3):
        state, _, metrics = jstep(state, shard_batch(mesh, x), None, None,
                                  jax.random.PRNGKey(7), 2e-4)
        losses_j.append(np.asarray(metrics["losses"]))
        if i == 0:
            path = str(tmp_path / "checkpoint_0.pt")
            jckpt.save_checkpoint(state.params["model"],
                                  state.params["criterion"], state.opt_state,
                                  state.params["model"], path)

    cfg = CPCConfig(**CFG40)
    model, crit = build_model(cfg), build_criterion(cfg)
    crit.wPrediction.heads.dropout = 0.0
    tstate = create_train_state(model, crit, "cpu", 2e-4)
    load_state_into(tstate, path, cfg, load_criterion=True,
                    load_optimizer=True)
    assert int(tstate.step) == 1
    step = make_train_step(tstate, "cpu")
    keys = torch.from_numpy(KEYS.astype(np.int64))
    for want in losses_j[1:]:
        _, metrics = step(x, round_keys=keys)
        np.testing.assert_allclose(metrics["losses"].numpy(), want,
                                   atol=1e-5)


def test_optimizer_state_of_another_shape_is_reinitialised(tmp_path,
                                                           capsys):
    cfg = JCPCConfig(**SMALL)
    jmodel, params = _jax_run(str(tmp_path), cfg)
    path = str(tmp_path / "checkpoint_0.pt")
    with open(path, "rb") as f:
        blob = pickle.load(f)
    blob["optimizer"] = ((np.zeros((), np.int32), {"model": {}},
                          {"model": {}}), ())
    with open(path, "wb") as f:
        pickle.dump(blob, f)
    tcfg = CPCConfig(**SMALL)
    tstate = create_train_state(build_model(tcfg), build_criterion(tcfg),
                                "cpu")
    load_state_into(tstate, path, tcfg, load_optimizer=True)
    assert "optimizer state incompatible; reinitialized" in \
        capsys.readouterr().out
    assert not tstate.optimizer.state and int(tstate.step) == 0


@pytest.mark.parametrize("case", ["version 1", "another class"])
def test_unreadable_pickles_are_refused(tmp_path, case):
    """A version-1 JAX checkpoint is refused with the JAX package's message;
    a pickle naming a class outside numpy and the JAX stack is refused by
    name, without running it."""
    path = str(tmp_path / "checkpoint_0.pt")
    if case == "version 1":
        _jax_run(str(tmp_path), JCPCConfig(**SMALL))
        with open(path, "rb") as f:
            blob = pickle.load(f)
        blob["version"] = 1
        with open(path, "wb") as f:
            pickle.dump(blob, f)
        with pytest.raises(ValueError, match="format v1"):
            tckpt.load_checkpoint(path)
        return
    with open(path, "wb") as f:
        pickle.dump({"format": "cpc_audio_tpu", "version": 2,
                     "gEncoder": os.getcwd}, f)
    with pytest.raises(pickle.UnpicklingError, match="posix.getcwd"):
        tckpt.load_checkpoint(path)


def _tree(root, n=6):
    sys.path.insert(0, os.path.join(REPO, "perf"))
    from soak_loader import make_tree
    make_tree(root, n, 2, min_s=0.6, max_s=0.9, tone=True, quiet=True)


def test_cli_loads_a_jax_pickle_and_exports(tmp_path):
    """train.main with --load of a JAX pickle and --export_torch, at
    learning rate 0 (the weights stay the loaded ones): its checkpoint
    holds the JAX weights, its checkpoint_0.torch.pt and the `convert
    export` CLI's file hold the same tensors, and JAX load_model of either
    gives the port's features."""
    cfg = JCPCConfig(**SMALL)
    jmodel, params = _jax_run(str(tmp_path / "jax"), cfg, seed=5)
    db, out = str(tmp_path / "db"), str(tmp_path / "out")
    _tree(db)
    argv = ["--pathDB", db, "--file_extension", ".wav", "--pathCheckpoint",
            out, "--batchSizeGPU", "4", "--nEpoch", "1",
            "--n_process_loader", "1", "--ignore_cache", "--random_seed",
            "3", "--learningRate", "0", "--export_torch", "--load",
            str(tmp_path / "jax" / "checkpoint_0.pt")] + \
        [a for k, v in SMALL.items() for a in (f"--{k}", str(v))]
    assert ttrain.main(argv, device="cpu") == 0
    assert sorted(os.listdir(out)) == [
        "checkpoint_0.pt", "checkpoint_0.torch.pt", "checkpoint_args.json",
        "checkpoint_logs.json"]
    model, _, _ = load_model([os.path.join(out, "checkpoint_0.pt")],
                             device="cpu")
    for k, v in tconvert.params_from_jax({"model": params}).items():
        torch.testing.assert_close(model.state_dict()[k[6:]], v, rtol=0,
                                   atol=0, msg=k)
    converted = os.path.join(out, "converted.pt")
    assert tconvert.main(["export", os.path.join(out, "checkpoint_0.pt"),
                          converted]) == 0
    a = torch.load(converted, weights_only=True)
    b = torch.load(os.path.join(out, "checkpoint_0.torch.pt"),
                   weights_only=True)
    assert a["cpcCriterion"] == {} and sorted(a) == sorted(b)
    assert sorted(a["gEncoder"]) == sorted(b["gEncoder"])
    for k, v in a["gEncoder"].items():
        torch.testing.assert_close(b["gEncoder"][k], v, rtol=0, atol=0)
    x = _waves(2, cfg.sizeWindow, 6)
    want = _port_forward(model, x)
    jm, jvars, _, _ = jfl.load_model([converted])
    got = jm.apply(jvars, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(got[0]), want[0], atol=1e-5)
    np.testing.assert_allclose(np.asarray(got[1]), want[1], atol=1e-5)


def test_probe_chain_and_concatenated_model(tmp_path):
    """A JAX probe checkpoint whose args name a pretrained checkpoint
    elsewhere (``load``), and two checkpoints side by side: the port's
    load_model gives the JAX load_model's c and z, and the same summed
    widths."""
    cfg_a = JCPCConfig(**SMALL)
    cfg_b = JCPCConfig(arMode="GRU", **dict(SMALL, hiddenGar=24))
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    _jax_run(a, cfg_a, seed=1)
    _jax_run(b, cfg_b, seed=2)
    probe = str(tmp_path / "probe")
    _, tuned = _jax_run(str(tmp_path / "tuned"), cfg_a, seed=3)
    _jax_run(probe, cfg_a, params=tuned,
             train_config=TrainConfig(load=[os.path.join(
                 a, "checkpoint_0.pt")]))
    x = _waves(2, cfg_a.sizeWindow, 8)
    for paths in ([os.path.join(probe, "checkpoint_0.pt")],
                  [os.path.join(a, "checkpoint_0.pt"),
                   os.path.join(b, "checkpoint_0.pt")]):
        jm, jvars, jhg, jhe = jfl.load_model(paths)
        want = jm.apply(jvars, jnp.asarray(x))
        model, hg, he = load_model(paths, device="cpu")
        assert (hg, he) == (jhg, jhe)
        assert isinstance(model, ConcatenatedModel) == (len(paths) == 2)
        c, z = _port_forward(model, x)
        np.testing.assert_allclose(c, np.asarray(want[0]), atol=1e-5)
        np.testing.assert_allclose(z, np.asarray(want[1]), atol=1e-5)
    with open(os.path.join(probe, "checkpoint_args.json")) as f:
        assert json.load(f)["load"]
