"""The port's training path (cpc_audio_tpu_torch) against the JAX package:
one ``make_train_step`` step of each on the same weights, batch and
Feistel round keys (float32 on the CPU, dropout off in both), the
prediction dropout that ``config.dropout`` turns on, and the ``train`` CLI
with its resume."""

import functools
import json
import os
import subprocess
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
from cpc_audio_tpu.parallel import get_mesh, shard_batch
from cpc_audio_tpu.parallel.train_step import TrainState as JTrainState
from cpc_audio_tpu.parallel.train_step import make_optimizer as jopt
from cpc_audio_tpu.parallel.train_step import \
    make_train_step as jmake_train_step
from cpc_audio_tpu.train import get_criterion
from cpc_audio_tpu_torch import train as ttrain
from cpc_audio_tpu_torch.convert import load_jax_params, params_from_jax
from cpc_audio_tpu_torch.criterion import build_criterion
from cpc_audio_tpu_torch.models import build_model
from cpc_audio_tpu_torch.parallel.train_step import (create_train_state,
                                                     epoch_key,
                                                     make_train_step,
                                                     step_streams)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The config of tests/test_torch_slice.py: D = 128, W = 124, B*S = 256 and
# 16 negatives resolve `auto` to the stratified sampler.
CFG = CPCConfig(hiddenEncoder=128, hiddenGar=128, nPredicts=4,
                negativeSamplingExt=16, sizeWindow=20480)
B = 2
LR = 2e-4
KEYS = np.array([0x12345678, 0x9ABCDEF0, 0x0F1E2D3C, 0xDEADBEEF, 0x2468ACE0],
                np.uint32)


def _waves(batch, n, seed):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16000.0
    f0 = rng.uniform(100, 400, size=(batch, 1))
    x = 0.3 * np.sin(2 * np.pi * f0 * t) + 0.05 * rng.randn(batch, n)
    return x[:, None, :].astype(np.float32)


def _flat(tree):
    return {k: v.numpy() for k, v in params_from_jax(tree).items()}


def test_train_step_matches_jax(monkeypatch):
    """Losses, accuracies, every gradient leaf and the parameters after
    one Adam step.  The JAX heads' dropout is patched to 0 here only, and
    the port's heads' rate set to 0; the round keys are injected into the
    JAX sampler as tests/test_torch_slice.py does."""
    _train_step_matches_jax(monkeypatch, CFG)


# --hiddenEncoder 40: a multiple of the heads' 8 but not of 32 (dk 5; K3
# masks the columns past D), on a 16-frame window (B*S = 32 keeps `auto`
# on the stratified sampler) and 2 predicted steps, so it stays cheap
CFG40 = CPCConfig(hiddenEncoder=40, hiddenGar=40, nPredicts=2,
                  negativeSamplingExt=8, sizeWindow=2560)


def test_train_step_matches_jax_at_a_width_no_multiple_of_32(monkeypatch):
    """The same step at --hiddenEncoder 40 --hiddenGar 40, which the JAX
    package trains on its jnp tail and attention."""
    _train_step_matches_jax(monkeypatch, CFG40)


def _train_step_matches_jax(monkeypatch, cfg):
    monkeypatch.setattr(jstacked, "StackedTransformerHeads",
                        functools.partial(jstacked.StackedTransformerHeads,
                                          dropout=0.0))
    for fn in ("feistel_permute", "feistel_inverse"):
        orig = getattr(jinfonce, fn)
        monkeypatch.setattr(jinfonce, fn, lambda x, _k, n, orig=orig: orig(
            x, jnp.asarray(KEYS), n))
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
                                 jax.random.PRNGKey(7), LR)
    # optax's first moment after one step is (1 - beta1) * grad
    grads_j = _flat(jax.tree_util.tree_map(
        lambda m: np.asarray(m) / (1.0 - cfg.beta1), state1.opt_state[0].mu))
    params0 = _flat(params)
    params1_j = _flat(state1.params)

    model, crit = build_model(cfg), build_criterion(cfg)
    load_jax_params(model, crit, params)
    crit.wPrediction.heads.dropout = 0.0
    state = create_train_state(model, crit, "cpu", LR, cfg.beta1, cfg.beta2,
                               cfg.epsilon)
    grads = {}
    _, metrics = make_train_step(state, "cpu")(
        x, round_keys=torch.from_numpy(KEYS.astype(np.int64)))
    for prefix, module in (("model.", model), ("criterion.", crit)):
        for name, p in module.named_parameters():
            grads[prefix + name] = p.grad.numpy()
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
        # in another order through 128 LSTM steps and the 2048-wide FFN
        w = grads_j[name]
        err = np.abs(g - w).max()
        assert err <= 1e-3 * np.abs(w).max() + 1e-8, (name, err)
    sd = {**{"model." + k: v for k, v in model.state_dict().items()},
          **{"criterion." + k: v for k, v in crit.state_dict().items()}}
    for name, p1 in params1_j.items():
        # Adam's first step moves an entry by lr * g / (|g| + eps), i.e.
        # +-lr wherever |g| >> eps; where the two gradients are both near
        # 0 their ratio can differ, so entries agree within lr there and
        # within 1e-3 * lr elsewhere.
        step_t = sd[name].numpy() - params0[name]
        step_j = p1 - params0[name]
        big = np.abs(grads_j[name]) > 1e-3 * np.abs(grads_j[name]).max()
        np.testing.assert_allclose(step_t[big], step_j[big],
                                   atol=1e-3 * LR, err_msg=name)
        assert np.abs(step_t - step_j).max() <= LR * 1.001, name


def test_prediction_dropout_follows_config():
    """config.dropout drops the predictions at rate 0.5 in training (the
    JAX PredictionNetwork's nn.Dropout(0.5)); without it they pass."""
    cfg = CPCConfig(hiddenEncoder=32, hiddenGar=32, nPredicts=2,
                    negativeSamplingExt=4, sizeWindow=5120)
    c = torch.from_numpy(np.random.RandomState(5).randn(4, 30, 32)
                         .astype(np.float32))
    seed = torch.tensor([11])
    for flag in (False, True):
        pred = build_criterion(cfg.replace(dropout=flag),
                               torch.Generator().manual_seed(0)).wPrediction
        pred.heads.dropout = 0.0
        with torch.no_grad():
            ev = pred(c)
            tr = pred(c, train=True, seed=seed)
        if not flag:
            torch.testing.assert_close(tr, ev, rtol=0, atol=0)
            continue
        kept = tr != 0
        share = kept.float().mean().item()
        sigma = (0.25 / kept.numel()) ** 0.5
        assert abs(share - 0.5) < 5 * sigma
        torch.testing.assert_close(tr[kept], 2 * ev[kept])


def test_train_steps_draw_new_streams_and_learn():
    """Each step derives its dropout seed and round keys on the device from
    (key, step): two steps on one batch differ in their streams, and a few
    steps on a fixed batch lower the loss."""
    cfg = CPCConfig(hiddenEncoder=32, hiddenGar=32, nPredicts=2,
                    negativeSamplingExt=4, sizeWindow=5120)
    gen = torch.Generator().manual_seed(1)
    state = create_train_state(build_model(cfg, gen),
                               build_criterion(cfg, gen), "cpu", 2e-3)
    step = make_train_step(state, "cpu")
    x = _waves(4, cfg.sizeWindow, 6)
    key = epoch_key(9, 0, "cpu")
    losses = [step(x, key=key)[1]["losses"].sum().item() for _ in range(6)]
    assert int(state.step) == 6
    assert losses[-1] < losses[0], losses
    s0, k0, n0 = step_streams(key, torch.tensor(0))
    s1, k1, n1 = step_streams(key, torch.tensor(1))
    assert not torch.equal(s0, s1) and not torch.equal(k0, k1)
    assert not torch.equal(n0, n1)


def _two_rank_cli(tmp_path, argv):
    """``--nGPU 2`` on the CPU: two spawned gloo ranks
    (tests/torch_dist_worker.py records each rank's batches and
    checkpoint writes).  Every step both ranks load the same global batch
    and train on its two halves; rank 0 alone writes one set of files;
    the run resumes, and prints windows/s a device."""
    out = str(tmp_path / "ckpt2")
    record = tmp_path / "record"
    record.mkdir()
    argv = list(argv)
    argv[argv.index("--pathCheckpoint") + 1] = out
    argv[argv.index("--batchSizeGPU") + 1] = "2"
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env.update(CPC_TEST_RECORD_DIR=str(record), OMP_NUM_THREADS="1")
    worker = os.path.join(REPO, "tests", "torch_dist_worker.py")
    for n_epoch in ("1", "2"):
        argv[argv.index("--nEpoch") + 1] = n_epoch
        r = subprocess.run([sys.executable, worker, "cli"] + argv
                           + ["--nGPU", "2"], env=env, capture_output=True,
                           text=True, timeout=300)
        assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
        assert "Let's use 2 devices" in r.stdout
        assert "windows/s/chip" in r.stdout
        recs = [json.loads((record / f"cli_rank{k}.json").read_text())
                for k in range(2)]
        assert recs[0]["saved_by"] == [0] and recs[1]["saved_by"] == []
        steps = [rec["steps"] for rec in recs]
        assert len(steps[0]) == len(steps[1]) > 0
        for s0, s1 in zip(*steps):
            assert s0["global"] == s1["global"] and s0["n"] == 2 * s0["b"]
            assert s0["rows"] == s0["half"] and s1["rows"] == s1["half"]
            assert s0["rows"] != s1["rows"]
    assert "Resuming from checkpoint" in r.stdout
    assert sorted(os.listdir(out)) == ["checkpoint_0.pt", "checkpoint_1.pt",
                                       "checkpoint_args.json",
                                       "checkpoint_logs.json"]
    with open(os.path.join(out, "checkpoint_logs.json")) as f:
        logs = json.load(f)
    assert logs["epoch"] == [0, 1]
    assert all(np.isfinite(v).all() for v in logs["locLoss_train"])


def test_train_cli_runs_and_resumes(tmp_path, capsys):
    sys.path.insert(0, os.path.join(REPO, "perf"))
    from soak_loader import make_tree
    root, out = str(tmp_path / "db"), str(tmp_path / "ckpt")
    make_tree(root, 8, 2, min_s=1.0, max_s=1.5, tone=True, quiet=True)
    argv = ["--pathDB", root, "--file_extension", ".wav",
            "--pathCheckpoint", out, "--hiddenEncoder", "32",
            "--hiddenGar", "32", "--nPredicts", "2",
            "--negativeSamplingExt", "4", "--sizeWindow", "5120",
            "--batchSizeGPU", "4", "--nEpoch", "1", "--n_process_loader",
            "1", "--ignore_cache", "--random_seed", "3"]
    assert ttrain.main(argv, device="cpu") == 0
    assert sorted(os.listdir(out)) == ["checkpoint_0.pt",
                                       "checkpoint_args.json",
                                       "checkpoint_logs.json"]
    argv[argv.index("--nEpoch") + 1] = "2"
    assert ttrain.main(argv, device="cpu") == 0
    assert "Resuming from checkpoint" in capsys.readouterr().out
    assert os.path.exists(os.path.join(out, "checkpoint_1.pt"))
    with open(os.path.join(out, "checkpoint_logs.json")) as f:
        logs = json.load(f)
    assert logs["epoch"] == [0, 1]
    assert all(np.isfinite(v).all() for v in logs["locLoss_train"])
    _two_rank_cli(tmp_path, argv)
    # a pickle, but not of a checkpoint (tests/test_torch_interchange.py
    # loads the JAX package's)
    not_ckpt = tmp_path / "not_a_checkpoint.pt"
    not_ckpt.write_bytes(b"\x80\x04N.")
    with pytest.raises(ValueError, match="is not a checkpoint"):
        ttrain.main(argv + ["--restart", "--load", str(not_ckpt)],
                    device="cpu")
