"""The port's supervised criteria, probes and hub against the JAX package
on the CPU in float32: each criterion's loss, accuracy and gradients, the
CTC label collapse, a phone train step and CLI epoch, a probe checkpoint
through ModelPhoneCombined, and the hub's local pretrained file."""

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
from cpc_audio_tpu import convert as jconvert
from cpc_audio_tpu import feature_loader as jfl
from cpc_audio_tpu.config import CPCConfig as JCPCConfig
from cpc_audio_tpu.config import TrainConfig as JTrainConfig
from cpc_audio_tpu.criterion import supervised as jsup
from cpc_audio_tpu.criterion.seq_alignment import \
    collapse_label_chain_padded as jcollapse
from cpc_audio_tpu.models import build_model as jbuild_model
from cpc_audio_tpu.parallel import get_mesh, shard_batch
from cpc_audio_tpu.parallel.train_step import TrainState as JTrainState
from cpc_audio_tpu.parallel.train_step import make_optimizer as jopt
from cpc_audio_tpu.parallel.train_step import \
    make_train_step as jmake_train_step
from cpc_audio_tpu_torch import hub
from cpc_audio_tpu_torch import train as ttrain
from cpc_audio_tpu_torch.config import CPCConfig
from cpc_audio_tpu_torch.convert import load_jax_params, params_from_jax
from cpc_audio_tpu_torch.criterion import (CTCPhoneCriterion, PhoneCriterion,
                                           SpeakerCriterion)
from cpc_audio_tpu_torch.criterion.seq_alignment import \
    collapse_label_chain_padded
from cpc_audio_tpu_torch.feature_loader import (FeatureModule,
                                                ModelPhoneCombined,
                                                load_model,
                                                load_supervised_criterion)
from cpc_audio_tpu_torch.models import build_model
from cpc_audio_tpu_torch.parallel.train_step import (create_train_state,
                                                     make_train_step)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(hiddenEncoder=32, hiddenGar=32, sizeWindow=3200)
B, S, D, P = 3, 12, 16, 5


def _features(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, S, D).astype(np.float32),
            rng.randn(B, S, D).astype(np.float32))


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


CRITERIA = {
    "speaker": (lambda: jsup.SpeakerCriterion(D, P),
                lambda: SpeakerCriterion(D, P)),
    "phone": (lambda: jsup.PhoneCriterion(D, P),
              lambda: PhoneCriterion(D, P)),
    "phone 2 layers": (lambda: jsup.PhoneCriterion(D, P, n_layers=2),
                       lambda: PhoneCriterion(D, P, n_layers=2)),
    "phone on encoder": (lambda: jsup.PhoneCriterion(D, P, on_encoder=True),
                         lambda: PhoneCriterion(D, P, on_encoder=True)),
    "ctc": (lambda: jsup.CTCPhoneCriterion(D, P),
            lambda: CTCPhoneCriterion(D, P)),
}


def _both(kind, c, z, label):
    """(JAX (loss, acc, grads), port (loss, acc, grads)) of one criterion
    on the same weights; grads of its parameters, of c and of z."""
    jcrit, tcrit = (f() for f in CRITERIA[kind])
    params = jcrit.init(jax.random.PRNGKey(3), jnp.asarray(c),
                        jnp.asarray(z), jnp.asarray(label))["params"]

    def loss_fn(p, c, z):
        loss, acc = jcrit.apply({"params": p}, c, z, jnp.asarray(label))
        return loss[0], acc

    (jl, jacc), jg = jax.value_and_grad(loss_fn, argnums=(0, 1, 2),
                                        has_aux=True)(
        params, jnp.asarray(c), jnp.asarray(z))
    want = {k[len("criterion."):]: v.numpy() for k, v in params_from_jax(
        {"criterion": jg[0]}).items()}
    want.update(c=np.asarray(jg[1]), z=np.asarray(jg[2]))
    load_jax_params(torch.nn.Module(), tcrit, {"criterion": params})
    tc, tz = (torch.from_numpy(a).requires_grad_() for a in (c, z))
    tl, tacc = tcrit(tc, tz, torch.from_numpy(label), train=True,
                     seed=torch.tensor([1]))
    tl.sum().backward()
    got = {n: p.grad.numpy() for n, p in tcrit.named_parameters()}
    got.update({n: np.zeros_like(a) if t.grad is None else t.grad.numpy()
                for n, t, a in (("c", tc, c), ("z", tz, z))})
    return (float(jl), np.asarray(jacc), want), \
        (tl.detach().numpy(), tacc.numpy(), got)


@pytest.mark.parametrize("kind", sorted(CRITERIA))
def test_criterion_matches_jax(kind):
    c, z = _features(1)
    rng = np.random.RandomState(2)
    label = rng.randint(P, size=B) if kind == "speaker" \
        else _frame_labels(rng, B, S, P)
    (jl, jacc, jg), (tl, tacc, tg) = _both(kind, c, z, label)
    assert tl.shape == (1,) and tacc.shape == (1,)
    np.testing.assert_allclose(tl[0], jl, atol=1e-5)
    np.testing.assert_allclose(tacc, jacc, atol=1e-7)
    assert sorted(tg) == sorted(jg)
    for name, g in jg.items():
        np.testing.assert_allclose(tg[name], g, atol=1e-5, err_msg=name)


def test_ctc_infeasible_sequence_counts_zero():
    """A row whose collapsed labels cannot fit the frames (labels longer
    than the context, alternating): the port counts its loss 0 and gives it
    no gradient, as the reference's nn.CTCLoss(zero_infinity=True).  The
    JAX package's optax CTC floors log-probabilities at -1e5 instead of
    -inf, so there the row is a finite ~1e5 that its isfinite test keeps;
    the feasible rows agree with JAX on their own."""
    c, z = _features(4)
    rng = np.random.RandomState(5)
    label = np.concatenate([_frame_labels(rng, B, S, P),
                            np.zeros((B, S), np.int64)], axis=1)
    label[0] = np.arange(2 * S) % 2              # 2S alternating phones
    crit = CTCPhoneCriterion(D, P)
    tc = torch.from_numpy(c).requires_grad_()
    loss, acc = crit(tc, None, torch.from_numpy(label))
    loss.sum().backward()
    assert torch.isfinite(loss).all() and acc.item() == 0.0
    assert torch.count_nonzero(tc.grad[0]) == 0
    assert torch.count_nonzero(tc.grad[1:]) > 0
    jcrit = jsup.CTCPhoneCriterion(D, P)
    params = jcrit.init(jax.random.PRNGKey(0), jnp.asarray(c[1:]), None,
                        jnp.asarray(label[1:]))["params"]
    load_jax_params(torch.nn.Module(), crit, {"criterion": params})
    feasible, _ = jcrit.apply({"params": params}, jnp.asarray(c[1:]), None,
                              jnp.asarray(label[1:]))
    got, _ = crit(torch.from_numpy(c), None, torch.from_numpy(label))
    # the mean over B rows of which one counts 0
    np.testing.assert_allclose(got.item() * B / (B - 1), float(feasible[0]),
                               atol=1e-5)


def test_collapse_label_chain_padded_matches_jax():
    rng = np.random.RandomState(7)
    labels = _frame_labels(rng, 6, 17, 4)
    labels[2] = 3                                 # one run over the row
    want = jcollapse(jnp.asarray(labels))
    got = collapse_label_chain_padded(torch.from_numpy(labels))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def _waves(batch, n, seed):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16000.0
    f0 = rng.uniform(100, 400, size=(batch, 1))
    x = 0.3 * np.sin(2 * np.pi * f0 * t) + 0.05 * rng.randn(batch, n)
    return x[:, None, :].astype(np.float32)


def test_phone_train_step_matches_jax():
    """One make_train_step step of an LSTM model under a phone probe, with
    frame-aligned labels: loss, accuracy and every gradient leaf (from
    optax's first moment) against the JAX package's step."""
    cfg = JCPCConfig(**SMALL)
    F = cfg.sizeWindow // 160
    x = _waves(2, cfg.sizeWindow, 8)
    labels = _frame_labels(np.random.RandomState(9), 2, F, P)
    jmodel = jbuild_model(cfg)
    jcrit = jsup.PhoneCriterion(cfg.hiddenGar, P)
    params = {"model": jmodel.init({"params": jax.random.PRNGKey(0)},
                                   jnp.asarray(x))["params"]}
    c, z, _, _ = jmodel.apply({"params": params["model"]}, jnp.asarray(x))
    params["criterion"] = jcrit.init(jax.random.PRNGKey(1), c, z,
                                     jnp.asarray(labels))["params"]
    optimizer = jopt()
    mesh = get_mesh(1)
    jstep = jmake_train_step(jmodel, jcrit, optimizer, mesh, donate=False)
    b, l = shard_batch(mesh, x, labels.astype(np.int32))
    state1, _, metrics_j = jstep(
        JTrainState(params, {}, optimizer.init(params),
                    jnp.zeros((), jnp.int32)), b, l, None,
        jax.random.PRNGKey(7), 2e-4)
    grads_j = {k: v.numpy() for k, v in params_from_jax(
        jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1,
                               state1.opt_state[0].mu)).items()}

    model = build_model(CPCConfig(**SMALL))
    crit = PhoneCriterion(cfg.hiddenGar, P)
    load_jax_params(model, crit, params)
    state = create_train_state(model, crit, "cpu", 2e-4)
    _, metrics = make_train_step(state, "cpu")(x, labels=labels)
    np.testing.assert_allclose(metrics["losses"].numpy(),
                               np.asarray(metrics_j["losses"]), atol=1e-5)
    np.testing.assert_allclose(metrics["acc"].numpy(),
                               np.asarray(metrics_j["acc"]), atol=1e-6)
    for prefix, mod in (("model.", model), ("criterion.", crit)):
        for n, p in mod.named_parameters():
            w = grads_j[prefix + n]
            # within 1e-3 of the leaf's largest entry: float32 sums in
            # another order through 20 LSTM steps
            assert np.abs(p.grad.numpy() - w).max() <= \
                1e-3 * np.abs(w).max() + 1e-8, n


def _db(root, n=6):
    sys.path.insert(0, os.path.join(REPO, "perf"))
    from soak_loader import make_tree
    make_tree(root, n, 2, min_s=0.6, max_s=0.9, tone=True, quiet=True)


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


@pytest.mark.parametrize("flags", [["--pathPhone"], ["--pathPhone", "--CTC"],
                                   []])
def test_supervised_cli_epoch(tmp_path, flags):
    """One epoch of the port's CLI with --supervised: a phone probe, the
    CTC one and the speaker one; finite losses, probe accuracies in
    [0, 1]."""
    db, out = str(tmp_path / "db"), str(tmp_path / "out")
    _db(db)
    phones = str(tmp_path / "phones.txt")
    _phone_file(db, phones)
    flags = [phones if f == "--pathPhone" else f for f in flags]
    if flags and flags[0] == phones:
        flags.insert(0, "--pathPhone")
    argv = ["--pathDB", db, "--file_extension", ".wav", "--pathCheckpoint",
            out, "--batchSizeGPU", "4", "--nEpoch", "1",
            "--n_process_loader", "1", "--ignore_cache", "--random_seed",
            "3", "--supervised"] + flags + \
        [a for k, v in SMALL.items() for a in (f"--{k}", str(v))]
    assert ttrain.main(argv, device="cpu") == 0
    with open(os.path.join(out, "checkpoint_logs.json")) as f:
        logs = json.load(f)
    loss = np.asarray(logs["locLoss_train"], np.float64)
    acc = np.asarray(logs["locAcc_train"], np.float64)
    assert loss.shape == (1, 1) and np.isfinite(loss).all()
    assert ((acc >= 0) & (acc <= 1)).all()


@pytest.mark.parametrize("ctc", [False, True])
def test_probe_checkpoint_through_model_phone_combined(tmp_path, ctc):
    """A JAX probe checkpoint (a phone or CTC criterion over a pretrained
    model named by ``load``): the port's load_supervised_criterion and
    ModelPhoneCombined give the JAX package's posteriors and one-hot."""
    cfg = JCPCConfig(**SMALL)
    base = str(tmp_path / "base")
    os.makedirs(base)
    jmodel = jbuild_model(cfg)
    x = _waves(2, cfg.sizeWindow, 10)
    mparams = jmodel.init({"params": jax.random.PRNGKey(4)},
                          jnp.asarray(x))["params"]
    jckpt.save_checkpoint(mparams, {}, {}, mparams,
                          os.path.join(base, "checkpoint_0.pt"))
    jckpt.save_args_sidecar(base, cfg)
    db = str(tmp_path / "db")
    _db(db, 2)
    phones = str(tmp_path / "phones.txt")
    _phone_file(db, phones)
    n_phones = 1 + max(int(v) for line in open(phones)
                       for v in line.split()[1:])
    probe = str(tmp_path / "probe")
    os.makedirs(probe)
    jcrit = (jsup.CTCPhoneCriterion if ctc else jsup.PhoneCriterion)(
        cfg.hiddenGar, n_phones)
    c, z, _, _ = jmodel.apply({"params": mparams}, jnp.asarray(x))
    cparams = jcrit.init(jax.random.PRNGKey(5), c, z,
                         jnp.zeros(c.shape[:2], jnp.int32))["params"]
    jckpt.save_checkpoint(mparams, cparams, {}, mparams,
                          os.path.join(probe, "checkpoint_0.pt"))
    jckpt.save_args_sidecar(probe, cfg, JTrainConfig(
        load=[os.path.join(base, "checkpoint_0.pt")], pathPhone=phones,
        CTC=ctc, supervised=True))
    path = os.path.join(probe, "checkpoint_0.pt")

    jm, jvars, _, _ = jfl.load_model([path])
    jcrit2, jcvars, jn = jfl.load_supervised_criterion(path)
    model, _, _ = load_model([path], device="cpu")
    crit, n = load_supervised_criterion(path, device="cpu")
    assert n == jn == n_phones
    for one_hot in (False, True):
        want = jfl.ModelPhoneCombined(jfl.FeatureModule(jm, jvars), jcrit2,
                                      jcvars, one_hot)(x)
        got = ModelPhoneCombined(FeatureModule(model), crit, one_hot)(x)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5)


def test_hub_loads_a_local_pretrained_file(tmp_path, monkeypatch):
    """A {"config", "weights"} file written from the JAX package's export
    of a model: cpc_audio(pretrained=True) gives that model's features;
    without a file it raises, naming the checkpoint and the variable."""
    cfg = JCPCConfig(**SMALL)
    jmodel = jbuild_model(cfg)
    x = _waves(2, cfg.sizeWindow, 11)
    params = jmodel.init({"params": jax.random.PRNGKey(6)},
                         jnp.asarray(x))["params"]
    path = str(tmp_path / "60k.pt")
    torch.save({"config": dict(SMALL),
                "weights": jconvert.export_cpc_model(params, cfg)}, path)
    c, z, _, _ = jmodel.apply({"params": params}, jnp.asarray(x))
    for kw in ({"checkpoint_path": path}, {}):
        if not kw:
            monkeypatch.setenv("CPC_AUDIO_CHECKPOINT", path)
        model = hub.CPC_audio(pretrained=True, device="cpu", **kw)
        with torch.no_grad():
            tc, tz, _, _ = model(torch.from_numpy(x))
        np.testing.assert_allclose(tc.numpy(), np.asarray(c), atol=1e-5)
        np.testing.assert_allclose(tz.numpy(), np.asarray(z), atol=1e-5)
    monkeypatch.delenv("CPC_AUDIO_CHECKPOINT")
    with pytest.raises(FileNotFoundError,
                       match="60k_epoch4-d0f474de.pt.*CPC_AUDIO_CHECKPOINT"):
        hub.cpc_audio(pretrained=True, device="cpu")
    fresh = hub.cpc_audio(device="cpu", **SMALL)
    assert fresh.config.hiddenEncoder == 32 and not fresh.training
