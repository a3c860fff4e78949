"""The port's linear-separability probe (cpc_audio_tpu_torch.eval.
linear_separability) against the JAX package's on the CPU in float32: one
probe step's losses, accuracies, gradients and updated parameters
(speaker, phone and CTC frozen, speaker unfrozen), the frozen step's K1
forward without residuals, a CLI epoch whose directory the port's
loaders read, and two epochs on two ranks against the JAX package's
--nGPU 2 run."""

import glob
import json
import os
import sys
import wave

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cpc_audio_tpu import checkpoint as jckpt
from cpc_audio_tpu.config import CPCConfig as JCPCConfig
from cpc_audio_tpu.criterion import supervised as jsup
from cpc_audio_tpu.eval import linear_separability as jls
from cpc_audio_tpu.models import build_model as jbuild_model
from cpc_audio_tpu.parallel import get_mesh, shard_batch
from cpc_audio_tpu.parallel.train_step import TrainState as JTrainState
from cpc_audio_tpu.parallel.train_step import make_optimizer as jopt
from cpc_audio_tpu_torch.config import CPCConfig
from cpc_audio_tpu_torch.convert import (jax_tree, load_jax_params,
                                         params_from_jax)
from cpc_audio_tpu_torch.criterion import (CTCPhoneCriterion, PhoneCriterion,
                                           SpeakerCriterion)
from cpc_audio_tpu_torch.eval import linear_separability as tls
from cpc_audio_tpu_torch.feature_loader import (load_model,
                                                load_supervised_criterion)
from cpc_audio_tpu_torch.models import build_model
from cpc_audio_tpu_torch.ops import lstm
from cpc_audio_tpu_torch.parallel.train_step import create_train_state
from grad_util import assert_grads_match

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(hiddenEncoder=32, hiddenGar=32, sizeWindow=3200)
P = 5                  # phones, and speakers
LR, EPS = 2e-4, 2e-8   # the CLI's --lr and --epsilon


def _frame_labels(rng, batch, frames, n_phones):
    """Runs of 1-4 frames of one phone."""
    out = np.zeros((batch, frames), np.int64)
    for b in range(batch):
        t = 0
        while t < frames:
            n = rng.randint(1, 5)
            out[b, t:t + n] = rng.randint(n_phones)
            t += n
    return out


def _waves(batch, n, seed):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16000.0
    f0 = rng.uniform(100, 400, size=(batch, 1))
    x = 0.3 * np.sin(2 * np.pi * f0 * t) + 0.05 * rng.randn(batch, n)
    return x[:, None, :].astype(np.float32)


PROBES = {"speaker": (jsup.SpeakerCriterion, SpeakerCriterion),
          "phone": (jsup.PhoneCriterion, PhoneCriterion),
          "ctc": (jsup.CTCPhoneCriterion, CTCPhoneCriterion)}


def _jax_probe_grads(jmodel, jcrit, params, x, labels, frozen):
    """The gradients of the summed losses that JAX's make_probe_step takes
    its Adam step on (its loss_fn), as the port's flat state dict."""
    x, labels = jnp.asarray(x), jnp.asarray(labels.astype(np.int32))

    def loss_fn(diff):
        p = {"model": params["model"], "criterion": diff} if frozen else diff
        c, z, _, _ = jmodel.apply({"params": p["model"]}, x, labels,
                                  train=not frozen)
        if frozen:
            c, z = jax.lax.stop_gradient(c), jax.lax.stop_gradient(z)
        losses, _ = jcrit.apply({"params": p["criterion"]}, c, z, labels,
                                train=True)
        return jnp.sum(losses)
    grads = jax.jit(jax.grad(loss_fn))(
        params["criterion"] if frozen else params)
    if frozen:
        grads = {"criterion": grads}
    return {k: v.numpy() for k, v in params_from_jax(
        jax.tree_util.tree_map(np.asarray, grads)).items()}


def _port_grads(model, crit, frozen):
    got = {f"criterion.{n}": p.grad for n, p in crit.named_parameters()}
    if not frozen:
        got.update({f"model.{n}": p.grad
                    for n, p in model.named_parameters()})
    return got


@pytest.mark.parametrize("kind,frozen", [("speaker", True), ("phone", True),
                                         ("ctc", True), ("speaker", False)])
def test_probe_step_matches_jax(kind, frozen):
    """One train step of JAX's make_probe_step and of the port's on the
    same weights, batch and labels: losses, accuracies, the gradients and
    every updated parameter (the frozen model's unchanged) within 1e-5."""
    cfg = JCPCConfig(**SMALL)
    frames = cfg.sizeWindow // 160
    x = _waves(2, cfg.sizeWindow, 3)
    rng = np.random.RandomState(4)
    labels = rng.randint(P, size=2) if kind == "speaker" \
        else _frame_labels(rng, 2, frames, P)
    jcls, tcls = PROBES[kind]
    jmodel, jcrit = jbuild_model(cfg), jcls(cfg.hiddenGar, P)
    mparams = jmodel.init({"params": jax.random.PRNGKey(0)},
                          jnp.asarray(x))["params"]
    c, z, _, _ = jmodel.apply({"params": mparams}, jnp.asarray(x))
    params = {"model": mparams,
              "criterion": jcrit.init(jax.random.PRNGKey(1), c, z,
                                      jnp.asarray(labels))["params"]}
    optimizer = jopt(0.9, 0.999, EPS)
    mesh = get_mesh(1)
    step = jls.make_probe_step(jmodel, jcrit, optimizer, mesh, frozen,
                               train=True)
    b, l = shard_batch(mesh, x, labels.astype(np.int32))
    state1, metrics_j = step(
        JTrainState(params, {}, optimizer.init(params),
                    jnp.zeros((), jnp.int32)), b, l,
        jax.random.PRNGKey(2), LR)
    want = {k: v.numpy() for k, v in params_from_jax(
        jax.tree_util.tree_map(np.asarray, state1.params)).items()}

    model, crit = build_model(CPCConfig(**SMALL)), tcls(cfg.hiddenGar, P)
    load_jax_params(model, crit, params)
    before = {f"model.{n}": p.detach().clone()
              for n, p in model.named_parameters()}
    state = create_train_state(model, crit, "cpu", LR, epsilon=EPS,
                               train_model=not frozen)
    metrics = tls.make_probe_step(state, "cpu", frozen, train=True)(
        x, labels)
    assert_grads_match(_port_grads(model, crit, frozen), _jax_probe_grads(
        jmodel, jcrit, params, x, labels, frozen))
    np.testing.assert_allclose(metrics["losses"].numpy(),
                               np.asarray(metrics_j["losses"]), atol=1e-5)
    np.testing.assert_allclose(metrics["acc"].numpy(),
                               np.asarray(metrics_j["acc"]), atol=1e-6)
    assert int(state.step) == 1
    for prefix, mod in (("model.", model), ("criterion.", crit)):
        for n, p in mod.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[prefix + n],
                                       atol=1e-5, err_msg=prefix + n)
            if frozen and prefix == "model.":
                assert torch.equal(p.detach(), before[prefix + n]), n


@pytest.mark.parametrize("frozen", [True, False])
def test_frozen_step_keeps_no_residuals(monkeypatch, frozen):
    """The frozen probe's model runs under no_grad: K1's forward is asked
    for no residuals (and autograd records no K1 call), though W_hh is a
    float32 parameter that requires grad; unfrozen, it saves them."""
    calls = []
    original = lstm.lstm_fwd

    def spy(*args, save_residuals=False):
        calls.append(save_residuals)
        return original(*args, save_residuals=save_residuals)
    monkeypatch.setattr(lstm, "lstm_fwd", spy)
    model = build_model(CPCConfig(**SMALL))
    state = create_train_state(model, SpeakerCriterion(32, P), "cpu",
                               train_model=not frozen)
    tls.make_probe_step(state, "cpu", frozen, train=True)(
        _waves(2, 3200, 5), np.array([0, 1]))
    assert calls == [not frozen]
    grads = [p.grad for p in model.parameters()]
    assert all(g is None for g in grads) == frozen


def _db(root, n=6, n_speakers=2):
    sys.path.insert(0, os.path.join(REPO, "perf"))
    from soak_loader import make_tree
    make_tree(root, n, n_speakers, min_s=0.6, max_s=0.9, tone=True,
              quiet=True)


def _phone_file(root, path, n_phones=P, seed=0):
    """Frame-aligned labels for every WAV under root."""
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        for wav in sorted(glob.glob(os.path.join(root, "*", "*.wav"))):
            with wave.open(wav) as w:
                frames = w.getnframes() // 160
            lab = _frame_labels(rng, 1, frames, n_phones)[0]
            name = os.path.splitext(os.path.basename(wav))[0]
            f.write(name + " " + " ".join(map(str, lab)) + "\n")


def _base_checkpoint(tmp_path):
    """A JAX-format pretrained checkpoint of the SMALL model."""
    cfg = JCPCConfig(**SMALL)
    base = str(tmp_path / "base")
    os.makedirs(base)
    jmodel = jbuild_model(cfg)
    mparams = jmodel.init({"params": jax.random.PRNGKey(7)},
                          jnp.zeros((1, 1, cfg.sizeWindow)))["params"]
    path = os.path.join(base, "checkpoint_0.pt")
    jckpt.save_checkpoint(mparams, {}, {}, mparams, path)
    jckpt.save_args_sidecar(base, cfg)
    return path


def _splits(tmp_path, db):
    names = sorted(os.path.splitext(os.path.basename(p))[0]
                   for p in glob.glob(os.path.join(db, "*", "*.wav")))
    train, val = tmp_path / "train.txt", tmp_path / "val.txt"
    train.write_text("\n".join(names[:4]) + "\n")
    val.write_text("\n".join(names[4:]) + "\n")
    return str(train), str(val)


@pytest.mark.parametrize("ctc", [False, True])
def test_phone_probe_cli_epoch_loads_back(tmp_path, ctc):
    """One frozen phone-probe epoch of the port's CLI on the CPU: finite
    logs, the sidecar with the model's config and onEncoder; the port's
    load_supervised_criterion and load_model read the directory back, the
    criterion holding the checkpoint's weights."""
    db = str(tmp_path / "db")
    _db(db)
    phones = str(tmp_path / "phones.txt")
    _phone_file(db, phones)
    ckpt_path = _base_checkpoint(tmp_path)
    out = str(tmp_path / "probe")
    train, val = _splits(tmp_path, db)
    argv = [db, train, val, ckpt_path, "--pathCheckpoint", out,
            "--pathPhone", phones, "--file_extension", ".wav",
            "--n_epoch", "1", "--batchSizeGPU", "4", "--size_window",
            "3200", "--ignore_cache"] + (["--CTC"] if ctc else [])
    assert tls.main(argv, device="cpu") == 0
    with open(os.path.join(out, "checkpoint_logs.json")) as f:
        logs = json.load(f)
    assert logs["epoch"] == [0]
    assert np.isfinite(np.asarray(logs["locLoss_train"], np.float64)).all()
    with open(os.path.join(out, "checkpoint_args.json")) as f:
        sidecar = json.load(f)
    assert sidecar["hiddenGar"] == 32 and sidecar["onEncoder"] is False
    assert sidecar["load"] == [ckpt_path] and sidecar["CTC"] == ctc
    path = os.path.join(out, "checkpoint_0.pt")
    crit, n_phones = load_supervised_criterion(path, device="cpu")
    assert isinstance(crit, CTCPhoneCriterion if ctc else PhoneCriterion)
    saved = torch.load(path, weights_only=True)["cpcCriterion"]
    for k, v in crit.state_dict().items():
        assert torch.equal(v, saved[k]), k
    model, hg, he = load_model([path], device="cpu")
    assert (hg, he) == (32, 32)


def test_probe_cli_on_two_ranks_matches_jax(tmp_path, monkeypatch, capfd):
    """Two epochs of the frozen speaker probe with --nGPU 2: the port on
    two spawned gloo ranks, the JAX package on get_mesh(2) from the
    port's initial probe weights (its init patched to them).  Both read
    the same loader batches (the port's copy of the data package, the same
    seed) of global batch 2 * batchSizeGPU; the logged losses agree within
    1e-6, the accuracies are equal, and one set of files is written."""
    db = str(tmp_path / "db")
    _db(db)
    ckpt_path = _base_checkpoint(tmp_path)
    train, val = _splits(tmp_path, db)
    argv = [db, train, val, ckpt_path, "--file_extension", ".wav",
            "--n_epoch", "2", "--batchSizeGPU", "2", "--size_window",
            "3200", "--ignore_cache", "--nGPU", "2", "--pathCheckpoint"]
    out_t, out_j = str(tmp_path / "port"), str(tmp_path / "jax")
    assert tls.main(argv + [out_t], device="cpu") == 0
    assert "Let's use 2 devices" in capfd.readouterr().out
    n_speakers = 2
    probe = tls.build_probe(SMALL["hiddenGar"], n_speakers, None, 0, False,
                            False, torch.Generator().manual_seed(0))
    fixed = jax_tree({"criterion." + k: v
                      for k, v in probe.state_dict().items()})["criterion"]

    class FromPort(jsup.SpeakerCriterion):
        def init(self, *args, **kwargs):
            return {"params": fixed}
    monkeypatch.setattr(jls, "SpeakerCriterion", FromPort)
    assert jls.main(argv + [out_j]) == 0
    logs = []
    for out in (out_t, out_j):
        with open(os.path.join(out, "checkpoint_logs.json")) as f:
            logs.append(json.load(f))
    assert logs[0]["epoch"] == logs[1]["epoch"] == [0, 1]
    # float32 features and Adam steps, sums in another order
    for key in ("locLoss_train", "locLoss_val"):
        np.testing.assert_allclose(logs[0][key], logs[1][key], atol=1e-6,
                                   err_msg=key)
    for key in ("locAcc_train", "locAcc_val"):
        assert logs[0][key] == logs[1][key], key
    assert sorted(os.listdir(out_t)) == ["checkpoint_1.pt",
                                         "checkpoint_args.json",
                                         "checkpoint_logs.json"]
