"""The port's materialised-negatives criterion against the JAX package: the
row scatter-add (K8's plain versions) against the Pallas
``scatter_add_rows`` in interpret mode, the exact, rolled and materialised
stratified samplers and ``_score_pair`` with their backwards, one train
step of each sampler resolution against the JAX ``make_train_step``, and
the train CLI on the exact sampler.  Float32 on the CPU; JAX's threefry
draws are replaced by a fixed key there and the indices it draws are
injected into the port."""

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
from cpc_audio_tpu.ops.pallas.scatter_add import \
    scatter_add_rows as jscatter_add_rows
from cpc_audio_tpu.parallel import get_mesh, shard_batch
from cpc_audio_tpu.parallel.train_step import TrainState as JTrainState
from cpc_audio_tpu.parallel.train_step import make_optimizer as jopt
from cpc_audio_tpu.parallel.train_step import \
    make_train_step as jmake_train_step
from cpc_audio_tpu.train import get_criterion
from cpc_audio_tpu_torch import train as ttrain
from cpc_audio_tpu_torch.convert import load_jax_params, params_from_jax
from cpc_audio_tpu_torch.criterion import build_criterion
from cpc_audio_tpu_torch.criterion import infonce as tinfonce
from cpc_audio_tpu_torch.models import build_model
from cpc_audio_tpu_torch.ops import dropout, scatter_add
from cpc_audio_tpu_torch.parallel.train_step import (create_train_state,
                                                     make_train_step)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_torch_train.py's config: D = 128, K = 4, N = 16, S = 128
CFG = CPCConfig(hiddenEncoder=128, hiddenGar=128, nPredicts=4,
                negativeSamplingExt=16, sizeWindow=20480)
LR = 2e-4
KEYS = np.array([0x12345678, 0x9ABCDEF0, 0x0F1E2D3C, 0xDEADBEEF, 0x2468ACE0],
                np.uint32)
SAMPLE_KEY = 11          # the JAX samplers' fixed PRNG key


def _np(t):
    return np.asarray(t)


def _jax_draws(shape, Bp, S):
    """The indices JAX's exact / rolled sampler draws from the fixed key
    (infonce.py:115-117, 143-145)."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(SAMPLE_KEY))
    return (torch.from_numpy(_np(jax.random.randint(k1, shape, 0, Bp))
                             .astype(np.int64)),
            torch.from_numpy(_np(jax.random.randint(k2, shape, 1, S))
                             .astype(np.int64)))


# ---- K8's plain versions ----------------------------------------------------

@pytest.mark.parametrize("J,C,R,ck,su,skewed", [
    (20000, 64, 512, 64, 1024, False), (20000, 64, 512, 64, 1024, True)])
def test_scatter_add_matches_pallas_interpret(J, C, R, ck, su, skewed):
    """scatter_add_rows_ref, the CPU wrapper and the sorted form (what K8
    computes) against the Pallas kernel in interpret mode, on uniform keys
    and on all keys on one row (the Pallas wrapper's fallback case,
    tests/test_ops.py:160-171).  rel < 1e-5: float32 sums of bf16 rows in
    another order."""
    rng = np.random.RandomState(0)
    upd = rng.randn(J, C).astype(np.float32)
    upd_bf = jnp.asarray(upd, jnp.bfloat16)
    keys = np.zeros(J, np.int32) if skewed else \
        rng.randint(0, R, J).astype(np.int32)
    want = _np(jscatter_add_rows(upd_bf, jnp.asarray(keys), R, chunk_rows=ck,
                                 sub_updates=su, interpret=True))
    upd_t = torch.from_numpy(np.array(upd_bf.astype(jnp.float32))).bfloat16()
    keys_t = torch.from_numpy(keys)
    scale = np.abs(want).max()
    for got in (scatter_add.scatter_add_rows_ref(upd_t, keys_t, R),
                scatter_add.scatter_add_rows(upd_t, keys_t, R),
                scatter_add.scatter_add_sorted(
                    upd_t, *scatter_add.sort_keys(keys_t, R))):
        assert got.dtype == torch.float32 and got.shape == (R, C)
        assert np.abs(got.numpy() - want).max() / scale < 1e-5


def test_sort_keys_gives_each_row_its_run():
    """order is a stable argsort and offsets bound each row's run; rows
    with no key get an empty run, and the sorted form sums them to 0."""
    keys = torch.tensor([3, 0, 3, 5, 0, 3])
    order, offsets = scatter_add.sort_keys(keys, 7)
    assert order.dtype == offsets.dtype == torch.int32
    assert order.tolist() == [1, 4, 0, 2, 5, 3]
    assert offsets.tolist() == [0, 2, 2, 2, 5, 5, 6, 6]
    upd = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    out = scatter_add.scatter_add_sorted(upd, order, offsets)
    torch.testing.assert_close(
        out, scatter_add.scatter_add_rows_ref(upd, keys, 7), rtol=0, atol=0)
    assert (out[[1, 2, 4, 6]] == 0).all()


def test_negative_indices_are_uniform_and_device_keyed():
    """The samplers' draws from ops/dropout.py: in range, each value about
    equally often (within 5 sigma), a function of the seed alone."""
    seed = torch.tensor([77])
    b, u = dropout.negative_indices(seed, (4, 16, 124), 3, 128)
    assert b.shape == u.shape == (4, 16, 124)
    assert b.min() >= 0 and b.max() < 3 and u.min() >= 1 and u.max() < 128
    n = b.numel()
    for counts, k in ((torch.bincount(b.flatten(), minlength=3), 3),
                      (torch.bincount(u.flatten() - 1, minlength=127), 127)):
        p = 1.0 / k
        assert (counts.double() - n * p).abs().max() < \
            5 * (n * p * (1 - p)) ** 0.5
    b2, u2 = dropout.negative_indices(seed, (4, 16, 124), 3, 128)
    assert torch.equal(b, b2) and torch.equal(u, u2)
    b3, _ = dropout.negative_indices(torch.tensor([78]), (4, 16, 124), 3, 128)
    assert not torch.equal(b, b3)


# ---- samplers and scorer ----------------------------------------------------

@pytest.mark.parametrize("mode", ["exact", "rolled"])
@pytest.mark.parametrize("Bp", [None, 5])
def test_samplers_match_jax(mode, Bp):
    """The port's exact / rolled sampler on the indices JAX draws from a
    fixed key: bit-equal negatives, with and without a pool of another
    batch size; the gather's backward (the scatter-add) against
    ``jax.vjp``, rel < 1e-6 (float32 sums in another order)."""
    rng = np.random.RandomState(3)
    B, S, C, W, N = 3, 20, 8, 17, 6
    z = rng.randn(B, S, C).astype(np.float32)
    pool = None if Bp is None else rng.randn(Bp, S, C).astype(np.float32)
    src = z if pool is None else pool
    jfn = jinfonce.sample_negatives if mode == "exact" \
        else jinfonce.sample_negatives_rolled
    tfn = tinfonce.sample_negatives if mode == "exact" \
        else tinfonce.sample_negatives_rolled
    # without a pool the negatives come from z: differentiate through it
    want, vjp = jax.vjp(lambda p: jfn(
        jax.random.PRNGKey(SAMPLE_KEY), jnp.asarray(z) if Bp else p, W, N,
        pool=p if Bp else None), jnp.asarray(src))
    shape = (B, N, W) if mode == "exact" else (B, N)
    src_t = torch.from_numpy(src).requires_grad_(True)
    idx, got = tfn(torch.from_numpy(z) if Bp else src_t, W, N,
                   *_jax_draws(shape, src.shape[0], S),
                   pool=src_t if Bp else None)
    assert idx.shape == (B * W, N)
    np.testing.assert_array_equal(got.detach().numpy(), _np(want))
    ct = rng.randn(B, W, N, C).astype(np.float32)
    got.backward(torch.from_numpy(ct))
    dwant = _np(vjp(jnp.asarray(ct))[0])
    assert np.abs(src_t.grad.numpy() - dwant).max() \
        <= 1e-6 * np.abs(dwant).max()


def _patch_feistel(monkeypatch):
    """JAX's stratified samplers take the fixed round keys KEYS."""
    for fn in ("feistel_permute", "feistel_inverse"):
        orig = getattr(jinfonce, fn)
        monkeypatch.setattr(jinfonce, fn, lambda x, _k, n, orig=orig: orig(
            x, jnp.asarray(KEYS), n))


@pytest.mark.parametrize("Bp", [None, 4])
def test_materialised_stratified_sampler_matches_jax(monkeypatch, Bp):
    """Forward bit-equal and VJP (block-gather correlation + inverse
    permutation) within 1e-6 of the largest entry against
    ``sample_negatives_stratified`` with the Feistel keys injected."""
    _patch_feistel(monkeypatch)
    rng = np.random.RandomState(4)
    B, S, C, N = 2, 32, 8, 8
    W = S - 4
    z = rng.randn(B, S, C).astype(np.float32)
    src = z if Bp is None else rng.randn(Bp, S, C).astype(np.float32)
    want, vjp = jax.vjp(lambda p: jinfonce.sample_negatives_stratified(
        jax.random.PRNGKey(0), jnp.asarray(z) if Bp else p, W, N,
        pool=p if Bp else None), jnp.asarray(src))
    src_t = torch.from_numpy(src).requires_grad_(True)
    keys = torch.from_numpy(KEYS.astype(np.int64))
    _, got = tinfonce.sample_negatives_stratified(
        torch.from_numpy(z) if Bp else src_t, W, N, keys,
        pool=src_t if Bp else None)
    np.testing.assert_array_equal(got.detach().numpy(), _np(want))
    ct = rng.randn(*got.shape).astype(np.float32)
    got.backward(torch.from_numpy(ct))
    dwant = _np(vjp(jnp.asarray(ct))[0])
    assert np.abs(src_t.grad.numpy() - dwant).max() \
        <= 1e-6 * np.abs(dwant).max()


def test_score_pair_matches_jax():
    """Forward float32 scores and the backward (dpred, dpos, dneg) against
    ``jax.vjp`` of ``_score_pair``: rel 1e-5, float32 sums of C = 32
    products in another order."""
    rng = np.random.RandomState(5)
    K, B, W, N, C = 3, 2, 7, 5, 32
    arrs = [rng.randn(*s).astype(np.float32)
            for s in ((K, B, W, C), (K, B, W, C), (B, W, N, C))]
    want, vjp = jax.vjp(lambda a, b, c: jinfonce._score_pair(a, b, c,
                                                             1.0 / C),
                        *map(jnp.asarray, arrs))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    got = tinfonce.score_pair(*ts, 1.0 / C)
    cts = [rng.randn(*g.shape).astype(np.float32) for g in got]
    torch.autograd.backward(got, [torch.from_numpy(c) for c in cts])
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.detach().numpy(), _np(w), rtol=1e-5,
                                   atol=1e-6)
    for t, w in zip(ts, vjp(tuple(map(jnp.asarray, cts)))):
        np.testing.assert_allclose(t.grad.numpy(), _np(w), rtol=1e-5,
                                   atol=1e-5 * np.abs(_np(w)).max())


@pytest.mark.parametrize("B,mode,stop,scope,want", [
    (2, "auto", False, "device", "fused stratified"),
    (3, "auto", False, "device", "exact"),
    (2, "auto", True, "device", "exact"),
    (2, "auto", False, "global", "exact"),
    (2, "stratified", True, "device", "stratified"),
    (2, "stratified", False, "global", "stratified"),
    (2, "rolled", False, "device", "rolled")])
def test_sampler_resolution(B, mode, stop, scope, want):
    """The mode x scope x stop-grad resolution of infonce.py:549-581."""
    crit = build_criterion(CFG.replace(negativeSamplingMode=mode,
                                       stopGradNegatives=stop,
                                       negative_sampling_scope=scope))
    assert crit.sampler(B, 128) == want


def test_criterion_rejects_what_jax_rejects():
    with pytest.raises(ValueError, match="negative_sampling_scope"):
        build_criterion(CFG.replace(negative_sampling_scope="world"))
    with pytest.raises(ValueError, match="sampling_mode"):
        build_criterion(CFG.replace(negativeSamplingMode="iid"))
    crit = build_criterion(CFG.replace(negativeSamplingMode="stratified"))
    c = torch.zeros(3, 128, 128)
    with pytest.raises(ValueError, match="power-of-two batch"):
        crit(c, c)


# ---- one train step against the JAX step ------------------------------------

def _waves(batch, n, seed):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16000.0
    f0 = rng.uniform(100, 400, size=(batch, 1))
    x = 0.3 * np.sin(2 * np.pi * f0 * t) + 0.05 * rng.randn(batch, n)
    return x[:, None, :].astype(np.float32)


def _flat(tree):
    return {k: v.numpy() for k, v in params_from_jax(tree).items()}


def _tied_anchors(idx, B, S, W, K):
    """(K,) count of anchors (b, w) that have a negative on their own
    positive frame b*S + w + k + 1 at step k, from the flat index (B*W, N)."""
    idx = idx.reshape(B, W, -1)
    frame = torch.arange(B)[:, None] * S + torch.arange(W)[None, :]
    return np.array([int((idx == (frame + k + 1)[..., None]).any(-1).sum())
                     for k in range(K)])


@pytest.mark.parametrize("B,override", [
    (3, {}),                                          # auto -> exact
    (2, {"negativeSamplingMode": "rolled"}),
    (2, {"negativeSamplingMode": "exact", "stopGradNegatives": True}),
    (2, {"negative_sampling_scope": "global"}),       # auto -> exact
    (2, {"negative_sampling_scope": "global",
         "negativeSamplingMode": "stratified"})],
    ids=["auto-exact", "rolled", "stopgrad-exact", "global-auto",
         "global-stratified"])
def test_train_step_matches_jax(monkeypatch, B, override):
    """Losses, accuracies, every gradient leaf and the Adam step of one
    train step, with tests/test_torch_train.py's tolerances.  The JAX heads'
    dropout is 0 and the port's rate 0; the JAX samplers take a fixed key
    whose draws (or the Feistel keys) are injected into the port."""
    cfg = CFG.replace(**override)
    monkeypatch.setattr(jstacked, "StackedTransformerHeads",
                        functools.partial(jstacked.StackedTransformerHeads,
                                          dropout=0.0))
    _patch_feistel(monkeypatch)
    for fn in ("sample_negatives", "sample_negatives_rolled"):
        orig = getattr(jinfonce, fn)
        monkeypatch.setattr(jinfonce, fn, lambda _k, *a, orig=orig, **kw:
                            orig(jax.random.PRNGKey(SAMPLE_KEY), *a, **kw))
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
    grads_j = _flat(jax.tree_util.tree_map(
        lambda m: np.asarray(m) / (1.0 - cfg.beta1), state1.opt_state[0].mu))
    params0 = _flat(params)
    params1_j = _flat(state1.params)

    model, crit = build_model(cfg), build_criterion(cfg)
    load_jax_params(model, crit, params)
    crit.wPrediction.heads.dropout = 0.0
    state = create_train_state(model, crit, "cpu", LR, cfg.beta1, cfg.beta2,
                               cfg.epsilon)
    S = cfg.sizeWindow // 160
    W, N = S - cfg.nPredicts, cfg.negativeSamplingExt
    mode = crit.sampler(B, S)
    keys = torch.from_numpy(KEYS.astype(np.int64))
    frames = torch.zeros(B, S, 1)
    negatives = None
    if mode == "stratified":
        idx, _ = tinfonce.sample_negatives_stratified(frames, W, N, keys)
    else:
        negatives = _jax_draws((B, N, W) if mode == "exact" else (B, N), B, S)
        sampler = tinfonce.sample_negatives if mode == "exact" \
            else tinfonce.sample_negatives_rolled
        idx, _ = sampler(frames, W, N, *negatives)
    _, metrics = make_train_step(state, "cpu")(
        x, round_keys=keys, negatives=negatives)
    grads = {prefix + name: p.grad.numpy()
             for prefix, module in (("model.", model), ("criterion.", crit))
             for name, p in module.named_parameters()}
    assert sorted(grads) == sorted(grads_j)

    # f32 throughout; sums in another order
    np.testing.assert_allclose(metrics["losses"].numpy(),
                               np.asarray(metrics_j["losses"]), atol=1e-5)
    # one anchor, as there, and each anchor with a negative on its own
    # positive frame: its two scores tie exactly, and the argmax of a tie
    # is left to the rounding of two sums taken in other orders in the
    # two packages (these samplers draw the positive frame; the rolled
    # one for all W anchors of a row at once)
    np.testing.assert_array_less(
        np.abs(metrics["acc"].numpy() - np.asarray(metrics_j["acc"])),
        (_tied_anchors(idx, B, S, W, cfg.nPredicts) + 1) / (B * W) + 1e-7)
    for name, g in grads.items():
        # each leaf within 1e-3 of its largest entry: float32 sums taken
        # in another order through 128 LSTM steps and the 2048-wide FFN
        w = grads_j[name]
        err = np.abs(g - w).max()
        assert err <= 1e-3 * np.abs(w).max() + 1e-8, (name, err)
    sd = {**{"model." + k: v for k, v in model.state_dict().items()},
          **{"criterion." + k: v for k, v in crit.state_dict().items()}}
    for name, p1 in params1_j.items():
        # Adam's first step: +-lr where |g| >> eps (test_torch_train.py)
        step_t = sd[name].numpy() - params0[name]
        step_j = p1 - params0[name]
        big = np.abs(grads_j[name]) > 1e-3 * np.abs(grads_j[name]).max()
        np.testing.assert_allclose(step_t[big], step_j[big],
                                   atol=1e-3 * LR, err_msg=name)
        assert np.abs(step_t - step_j).max() <= LR * 1.001, name


def test_train_cli_runs_exact_sampler(tmp_path, capsys):
    """One CPU epoch of the CLI with --negativeSamplingMode exact and
    --stopGradNegatives off: finite losses, a checkpoint, and the exact
    sampler's gather backward on the plain scatter-add."""
    sys.path.insert(0, os.path.join(REPO, "perf"))
    from soak_loader import make_tree
    root, out = str(tmp_path / "db"), str(tmp_path / "ckpt")
    make_tree(root, 8, 2, min_s=1.0, max_s=1.5, tone=True, quiet=True)
    argv = ["--pathDB", root, "--file_extension", ".wav",
            "--pathCheckpoint", out, "--hiddenEncoder", "32",
            "--hiddenGar", "32", "--nPredicts", "2",
            "--negativeSamplingExt", "4", "--sizeWindow", "5120",
            "--batchSizeGPU", "3", "--nEpoch", "1", "--n_process_loader",
            "1", "--ignore_cache", "--random_seed", "3",
            "--negativeSamplingMode", "exact"]
    assert ttrain.main(argv, device="cpu") == 0
    assert "checkpoint_0.pt" in os.listdir(out)
    logs = capsys.readouterr().out
    assert '"negativeSamplingMode": "exact"' in logs
    with open(os.path.join(out, "checkpoint_logs.json")) as f:
        assert np.isfinite(json.load(f)["locLoss_train"]).all()
