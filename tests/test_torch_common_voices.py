"""The port's Common Voice transfer (cpc_audio_tpu_torch.eval.common_voices)
and PER helpers (criterion/seq_alignment.py) against the JAX package's on
the CPU: the CTC head's loss and gradients, one train step (frozen and
fine-tuned), the beam search, the PER, a port train whose per equals the
JAX package's per on the same weights, per over a JAX-written checkpoint
in both packages, and the empty-dataset error."""

import contextlib
import glob
import io
import os
import pickle
import re
import shutil
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cpc_audio_tpu import checkpoint as jckpt
from cpc_audio_tpu.config import CPCConfig as JCPCConfig
from cpc_audio_tpu.criterion import seq_alignment as jsa
from cpc_audio_tpu.eval import common_voices as jcv
from cpc_audio_tpu.feature_loader import load_model as jload_model
from cpc_audio_tpu.models import build_model as jbuild_model
from cpc_audio_tpu.parallel import make_optimizer as jopt
from cpc_audio_tpu_torch.convert import (jax_tree, load_jax_params,
                                         params_from_jax)
from cpc_audio_tpu_torch.criterion import seq_alignment as tsa
from cpc_audio_tpu_torch.data import find_all_seqs, parse_seq_labels
from cpc_audio_tpu_torch.eval import common_voices as tcv
from cpc_audio_tpu_torch.feature_loader import load_model
from cpc_audio_tpu_torch.ops import native
from cpc_audio_tpu_torch.parallel.train_step import create_train_state
from grad_util import assert_grads_match

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(hiddenEncoder=32, hiddenGar=32, sizeWindow=3200)
B, S, H, P = 3, 40, 16, 5


def _labels(rng, sizes, n_phones=P, width=None):
    """Phone sequences with no phone twice in a row, zero-padded."""
    out = np.zeros((len(sizes), width or max(sizes)), np.int64)
    for b, n in enumerate(sizes):
        prev = -1
        for t in range(n):
            prev = (prev + 1 + rng.randint(n_phones - 1)) % n_phones
            out[b, t] = prev
    return out


@pytest.mark.parametrize("lstm,seq_norm,reduction", [
    (False, False, "mean"), (True, False, "mean"), (False, True, "sum"),
    (True, True, "sum")])
def test_ctc_head_matches_jax(lstm, seq_norm, reduction):
    """CTCPhoneCriterionCV's loss and its gradients (every parameter and
    the features) against the JAX head on the same weights, within 1e-5;
    ragged feature and label lengths."""
    rng = np.random.RandomState(1)
    c = rng.randn(B, S, H).astype(np.float32)
    fsize = np.array([S, 33, 25])
    lsize = np.array([4, 3, 2])
    label = _labels(rng, lsize)
    jcrit = jcv.CTCPhoneCriterionCV(H, P, lstm, seq_norm=seq_norm,
                                    reduction=reduction)
    args = (jnp.asarray(fsize), jnp.asarray(label), jnp.asarray(lsize))
    params = jcrit.init({"params": jax.random.PRNGKey(0),
                         "dropout": jax.random.PRNGKey(1)},
                        jnp.asarray(c), *args)["params"]
    jloss, (jg_p, jg_c) = jax.value_and_grad(
        lambda p, x: jcrit.apply({"params": p}, x, *args),
        argnums=(0, 1))(params, jnp.asarray(c))
    want = {k[len("criterion."):]: v.numpy() for k, v in params_from_jax(
        {"criterion": jg_p}).items()}

    crit = tcv.CTCPhoneCriterionCV(H, P, lstm, seq_norm=seq_norm,
                                   reduction=reduction)
    load_jax_params(torch.nn.Module(), crit, {"criterion": params})
    tc = torch.from_numpy(c).requires_grad_()
    loss = crit(tc, torch.from_numpy(fsize), torch.from_numpy(label),
                torch.from_numpy(lsize))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-5,
                               rtol=1e-6)
    np.testing.assert_allclose(tc.grad.numpy(), np.asarray(jg_c), atol=1e-5)
    got = {n: p.grad.numpy() for n, p in crit.named_parameters()}
    assert sorted(got) == sorted(want)
    for n, g in want.items():
        np.testing.assert_allclose(got[n], g, atol=1e-5, err_msg=n)


@pytest.mark.parametrize("T", [30, 120, 225])
def test_python_beam_search_matches_native(T):
    """The port's Python beam search gives the native kernel's beams on
    long, flat posteriors (Common Voice's 225 frames of 21 classes), where
    float32 beam probabilities underflow to 0 (the JAX package's Python
    search, float32 under NumPy 2, loses the ranking there)."""
    if not native.available():
        pytest.skip("the native library is not built")
    rng = np.random.RandomState(T)
    x = np.exp(rng.randn(T, P + 16) * 0.3)
    post = (x / x.sum(axis=1, keepdims=True)).astype(np.float32)
    got = tsa.beam_search_py(post, 20, P + 15)
    want = native.beam_search(post, 20, P + 15)
    assert [b for _, b in got] == [b for _, b in want]
    np.testing.assert_allclose([s for s, _ in got], [s for s, _ in want],
                               rtol=1e-9)
    assert got[0][0] > 0.0


def _posteriors(rng, T, n):
    x = np.exp(rng.randn(T, n) * 2)
    return (x / x.sum(axis=1, keepdims=True)).astype(np.float32)


def test_beam_search_and_per_match_jax():
    """The beam search (native and Python), get_seq_per and get_per give
    the JAX package's results on the same posteriors (the Python search's
    scores within float32's rounding: the port's runs in double, the JAX
    package's in float32)."""
    rng = np.random.RandomState(2)
    for t in (1, 7, 30):
        post = _posteriors(rng, t, P + 1)
        for fn, rtol in (("beam_search", 1e-12), ("beam_search_py", 1e-5)):
            got = getattr(tsa, fn)(post, 10, P)
            want = getattr(jsa, fn)(post, 10, P)
            assert [b for _, b in got] == [b for _, b in want], fn
            np.testing.assert_allclose([s for s, _ in got],
                                       [s for s, _ in want], rtol=rtol)
    for _ in range(5):
        a = rng.randint(P, size=rng.randint(1, 12))
        b = rng.randint(P, size=rng.randint(1, 12))
        assert tsa.get_seq_per(a, b) == jsa.get_seq_per(a, b)
        assert tsa.needleman_wunsch_align_score(a, b, -1, -1, 0) == \
            jsa.needleman_wunsch_align_score(a, b, -1, -1, 0)
    frames = rng.randint(P, size=(4, 20))
    collapsed = tsa.collapse_label_chain(frames)
    for g, w in zip(collapsed, jsa.collapse_label_chain(frames)):
        np.testing.assert_array_equal(g, w)
    data = [(np.stack([_posteriors(rng, 20, P + 1) for _ in range(4)]),
             frames) for _ in range(2)]
    got = tsa.get_per(iter(data), lambda x: torch.from_numpy(x), P,
                      pool_size=1)
    want = jsa.get_per(iter(data), lambda x: x, P, pool_size=1)
    assert got == want


@pytest.fixture(scope="module")
def cv_fixture(tmp_path_factory):
    """A 6-file WAV tree of 0.6-0.9 s, phone sequences for it (4-8 phones a
    file, none twice in a row) and a JAX-format pretrained checkpoint."""
    root = tmp_path_factory.mktemp("cv")
    db = str(root / "db")
    sys.path.insert(0, os.path.join(REPO, "perf"))
    from soak_loader import make_tree
    make_tree(db, 6, 2, min_s=0.6, max_s=0.9, tone=True, quiet=True)
    rng = np.random.RandomState(3)
    phones = str(root / "phones.txt")
    with open(phones, "w") as f:
        for wav in sorted(glob.glob(os.path.join(db, "*", "*.wav"))):
            lab = _labels(rng, [rng.randint(4, 9)])[0]
            name = os.path.splitext(os.path.basename(wav))[0]
            f.write(name + " " + " ".join(map(str, lab)) + "\n")
    cfg = JCPCConfig(**SMALL)
    base = str(root / "base")
    os.makedirs(base)
    jmodel = jbuild_model(cfg)
    mparams = jmodel.init({"params": jax.random.PRNGKey(5)},
                          jnp.zeros((1, 1, cfg.sizeWindow)))["params"]
    ckpt = os.path.join(base, "checkpoint_0.pt")
    jckpt.save_checkpoint(mparams, {}, {}, mparams, ckpt)
    jckpt.save_args_sidecar(base, cfg)
    names = sorted(os.path.splitext(os.path.basename(p))[0]
                   for p in glob.glob(os.path.join(db, "*", "*.wav")))
    splits = []
    for name, part in (("train", names[:4]), ("val", names[4:])):
        splits += [f"--path{name.capitalize()}", str(root / f"{name}.txt")]
        (root / f"{name}.txt").write_text("\n".join(part) + "\n")
    return db, phones, ckpt, splits


@pytest.mark.parametrize("frozen,seq_norm", [(True, True), (False, False)])
def test_train_step_matches_jax(cv_fixture, frozen, seq_norm):
    """One step of the port's make_train_step (--LSTM; --freeze, or the
    model fine-tuned) against JAX's on the same checkpoint, head weights
    and batch of two padded utterances: the loss, the gradients (each leaf
    within 1e-5 of its norm) and every updated parameter within 1e-5."""
    db, phones, ckpt, _ = cv_fixture
    labels, n_phones = parse_seq_labels(phones)
    seqs, _ = find_all_seqs(db, extension=".wav")
    batch = next(tcv.SingleSequenceDataset(db, seqs, labels).batches(
        2, shuffle=False))
    seq, ss, ph, sp = batch
    jmodel, variables, hidden, _ = jload_model([ckpt])
    jcrit = jcv.CTCPhoneCriterionCV(hidden, n_phones, True,
                                    seq_norm=seq_norm)
    cparams = jcrit.init({"params": jax.random.PRNGKey(6),
                          "dropout": jax.random.PRNGKey(1)},
                         jnp.zeros((2, 16, hidden)), jnp.full((2,), 16),
                         jnp.zeros((2, 8), jnp.int32),
                         jnp.full((2,), 8))["params"]
    params = {"model": variables["params"], "criterion": cparams}
    optimizer = jopt(0.9, 0.999, 1e-8)
    jstep = jcv._make_steps(jmodel, variables, jcrit, cparams, optimizer,
                            frozen, 160)[0]
    key = jax.random.PRNGKey(0)
    params1, _, jloss = jstep(params, optimizer.init(params), *batch, key,
                              0, 2e-4)

    def loss_fn(diff):
        p = {"model": params["model"], "criterion": diff} if frozen else diff
        c = jmodel.apply({**variables, "params": p["model"]}, seq, None,
                         train=False)[0]
        if frozen:
            c = jax.lax.stop_gradient(c)
        return jcrit.apply({"params": p["criterion"]}, c, ss // 160, ph, sp,
                           train=True, rngs={"dropout": key})
    grads = jax.jit(jax.grad(loss_fn))(cparams if frozen else params)
    want_grads = {k: v.numpy() for k, v in params_from_jax(
        {"criterion": grads} if frozen else grads).items()}
    want = {k: v.numpy() for k, v in params_from_jax(params1).items()}

    model = load_model([ckpt], device="cpu")[0]
    crit = tcv.CTCPhoneCriterionCV(hidden, n_phones, True,
                                   seq_norm=seq_norm)
    load_jax_params(torch.nn.Module(), crit, {"criterion": cparams})
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = create_train_state(model, crit, "cpu", 2e-4,
                               train_model=not frozen)
    loss = tcv.make_train_step(state, "cpu", frozen, 160)(*batch)
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-5,
                               rtol=1e-6)
    got = {f"criterion.{n}": p.grad for n, p in crit.named_parameters()}
    if not frozen:
        got.update({f"model.{n}": p.grad
                    for n, p in model.named_parameters()})
    assert_grads_match(got, want_grads)
    assert int(state.step) == 1
    for prefix, mod in (("model.", model), ("criterion.", crit)):
        for n, p in mod.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[prefix + n],
                                       atol=1e-5, err_msg=prefix + n)
            if frozen and prefix == "model.":
                assert p.grad is None and torch.equal(p.detach(),
                                                      before[n]), n


def _per_of(main, argv, **kw):
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        assert main(argv, **kw) == 0
    found = re.findall(r"Average PER (\S+)", log.getvalue())
    assert len(found) == 1, log.getvalue()[-2000:]
    return float(found[0])


def test_port_train_and_per(tmp_path, cv_fixture):
    """The port's train (fine-tuned, --LSTM, 2 epochs) and per on the CPU:
    the port's checkpoint.pt, a finite, non-negative average PER, and the
    JAX package's per on the same weights (the checkpoint written in its
    format by convert.jax_tree) giving the same PER.  Exact: the
    posteriors agree to ~1e-6 and no beam of these utterances lies that
    close to another."""
    db, phones, ckpt, splits = cv_fixture
    out = str(tmp_path / "cv")
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        assert tcv.main(["train", db, phones, ckpt, "--file_extension",
                         ".wav", "--batchSize", "2", "--nEpochs", "2",
                         "--LSTM", "-o", out] + splits, device="cpu") == 0
    losses = [float(x) for x in re.findall(r"loss train : (\S+)",
                                           log.getvalue())]
    assert len(losses) == 2 and np.isfinite(losses).all()
    data = torch.load(os.path.join(out, "checkpoint.pt"), weights_only=True)
    assert data["format"] == "cpc_audio_tpu_torch"
    assert "conv1.weight_ih" in data["classifier"]
    per = _per_of(tcv.main, ["per", out, "--batchSize", "2"], device="cpu")
    assert np.isfinite(per) and per >= 0.0
    assert os.path.exists(os.path.join(out, "args_validation_0.json"))

    jout = str(tmp_path / "cv_jax")
    os.makedirs(jout)
    shutil.copy(os.path.join(out, "args_training.json"), jout)
    blob = {"format": "cpc_audio_tpu", "version": 1,
            "classifier": jax_tree(data["classifier"]),
            "model": jax_tree(data["model"]), "bestLoss": data["bestLoss"]}
    with open(os.path.join(jout, "checkpoint.pt"), "wb") as f:
        pickle.dump(blob, f, protocol=4)
    assert _per_of(jcv.main, ["per", jout, "--batchSize", "2"]) == per


def test_per_of_a_jax_checkpoint_matches_jax(tmp_path, cv_fixture):
    """A checkpoint.pt the JAX package trained (--LSTM --seqNorm, frozen,
    one epoch), read by the port's per through its JAX-free unpickler: the
    average PER equals the JAX package's own per on it.  Exact: the
    posteriors agree to ~1e-6 and no beam of these utterances lies that
    close to another."""
    db, phones, ckpt, splits = cv_fixture
    out = str(tmp_path / "cv")
    with contextlib.redirect_stdout(io.StringIO()):
        assert jcv.main(["train", db, phones, ckpt, "--file_extension",
                         ".wav", "--batchSize", "2", "--nEpochs", "1",
                         "--LSTM", "--seqNorm", "--freeze", "-o", out]
                        + splits) == 0
    want = _per_of(jcv.main, ["per", out, "--batchSize", "2"])
    got = _per_of(tcv.main, ["per", out, "--batchSize", "2"], device="cpu")
    assert got == want


def test_per_refuses_an_empty_dataset(cv_fixture):
    db = cv_fixture[0]
    seqs = [(0, os.path.relpath(p, db)) for p in
            glob.glob(os.path.join(db, "*", "*.wav"))]
    empty = tcv.SingleSequenceDataset(db, seqs, {})
    with pytest.raises(ValueError, match="no utterance"):
        tcv.per_step(empty, None, 2, 160, P)
