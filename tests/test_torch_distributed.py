"""The port's data parallelism (cpc_audio_tpu_torch/parallel/distributed.py)
against the JAX package's ``shard_map`` steps on its virtual CPU devices.

Two gloo ranks run in worker processes (tests/torch_dist_worker.py, which
imports no JAX) on the CPU; arrays pass through files in a temporary
directory.  One pair of workers runs every step scenario: CFG40's train
step (tests/test_torch_train.py) against JAX's ``make_train_step`` on
``get_mesh(2)``, the global negative pool against ``all_gather`` and its
transpose, batchNorm's statistics against the sharded step's ``pmean``,
and steps with parameters outside the loss's graph.  In this process: a
world-1 group against no group, the ranks' streams, the file shards, and
two ``--distributed`` trainer processes."""

import functools
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from cpc_audio_tpu.config import CPCConfig as JCPCConfig
from cpc_audio_tpu.config import TrainConfig as JTrainConfig
from cpc_audio_tpu.criterion import CPCUnsupervisedCriterion
from cpc_audio_tpu.criterion import infonce as jinfonce
from cpc_audio_tpu.criterion import stacked_heads as jstacked
from cpc_audio_tpu.models import build_model as jbuild_model
from cpc_audio_tpu.parallel import get_mesh, shard_batch
from cpc_audio_tpu.parallel.distributed import \
    shard_sequences as jshard_sequences
from cpc_audio_tpu.parallel.train_step import TrainState as JTrainState
from cpc_audio_tpu.parallel.train_step import make_optimizer as jopt
from cpc_audio_tpu.parallel.train_step import \
    make_train_step as jmake_train_step
from cpc_audio_tpu.train import get_criterion
from cpc_audio_tpu_torch.config import CPCConfig
from cpc_audio_tpu_torch.convert import _stats_from_jax, load_jax_params
from cpc_audio_tpu_torch.criterion import build_criterion
from cpc_audio_tpu_torch.models import build_model
from cpc_audio_tpu_torch.parallel import distributed
from cpc_audio_tpu_torch.parallel.train_step import (create_train_state,
                                                     epoch_key,
                                                     make_train_step,
                                                     step_streams)
from test_torch_train import CFG40, KEYS, LR, _flat, _waves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dist_worker.py")
N_RANKS = 2
B_RANK = 2                 # rows a rank
# tests/test_distributed.py's batchNorm config (hiddenEncoder 16, GRU)
BN_CFG = dict(hiddenEncoder=16, hiddenGar=16, nPredicts=2,
              negativeSamplingExt=4, sizeWindow=3200, arMode="GRU",
              rnnMode="linear")


def _port_cfg(cfg) -> CPCConfig:
    return CPCConfig.from_dict(cfg.to_dict())


def _port_state_dict(cfg, params, batch_stats=None) -> dict:
    """The port's flat state dict (``model.*``, ``criterion.*``) of JAX
    parameters."""
    model, crit = build_model(_port_cfg(cfg)), build_criterion(_port_cfg(cfg))
    load_jax_params(model, crit, params, batch_stats)
    return {**{"model." + k: v for k, v in model.state_dict().items()},
            **{"criterion." + k: v for k, v in crit.state_dict().items()}}


def _jax_init(jmodel, jcrit, x):
    """(params, batch_stats) of the JAX model and criterion (jitted: the
    eager init takes tens of seconds on the CPU)."""
    variables = jax.jit(lambda k, x: jmodel.init({"params": k}, x,
                                                  train=True))(
        jax.random.PRNGKey(0), jnp.asarray(x))
    c, z, _, _ = jax.jit(lambda v, x: jmodel.apply(v, x))(
        variables, jnp.asarray(x))
    params = {"model": variables["params"], "criterion": jax.jit(
        lambda rngs, c, z: jcrit.init(rngs, c, z, None))(
        {"params": jax.random.PRNGKey(1),
         "sampling": jax.random.PRNGKey(2)}, c, z)["params"]}
    stats = {"model": variables["batch_stats"]} \
        if "batch_stats" in variables else {}
    return params, stats


def _injected_exact(draws):
    """JAX's exact sampler (infonce.py:93-122) with device d's draws taken
    from ``draws`` (batch indices and time offsets, each (world, B, N, W))
    in place of its threefry stream."""
    batch_all, off_all = (jnp.asarray(a.numpy()) for a in draws)

    def sample(key, encoded_data, window_size, n_negative, pool=None):
        if pool is None:
            pool = encoded_data
        Bp, S, C = pool.shape
        d = jax.lax.axis_index("data")
        seq_idx = (off_all[d] + jnp.arange(window_size)[None, None, :]) % S
        flat_idx = (batch_all[d] * S + seq_idx).transpose(0, 2, 1).reshape(-1)
        neg = jnp.take(pool.reshape(Bp * S, C), flat_idx, axis=0)
        return neg.reshape(encoded_data.shape[0], window_size, n_negative, C)
    return sample


def _step_case(scope="device"):
    """CFG40 at B_RANK rows a rank: the port's inputs, and the JAX 2-device
    step (heads' dropout 0, the Feistel keys KEYS on every device) as a
    function.  Under the global scope (the exact sampler on every rank's
    batch) both take the same draws on each rank, which reach rows of
    every rank."""
    cfg = CFG40.replace(negative_sampling_scope=scope)
    jmodel = jbuild_model(cfg)
    jcrit = get_criterion(cfg, JTrainConfig(), 160, 0, 0)
    x = _waves(N_RANKS * B_RANK, cfg.sizeWindow, 4)
    params, _ = _jax_init(jmodel, jcrit, x)
    optimizer = jopt(cfg.beta1, cfg.beta2, cfg.epsilon)
    state0 = JTrainState(params, {}, optimizer.init(params),
                         jnp.zeros((), jnp.int32))
    S = cfg.sizeWindow // 160
    shape = (N_RANKS, B_RANK, cfg.negativeSamplingExt, S - cfg.nPredicts)
    rng = np.random.RandomState(9)
    draws = [torch.from_numpy(rng.randint(lo, hi, size=shape))
             for lo, hi in ((0, N_RANKS * B_RANK), (1, S))]

    def ref():
        mesh = get_mesh(N_RANKS)
        with pytest.MonkeyPatch.context() as mp:
            if scope == "global":
                mp.setattr(jinfonce, "sample_negatives",
                           _injected_exact(draws))
            jstep = jmake_train_step(jmodel, jcrit, optimizer, mesh,
                                     donate=False)
            state1, _, metrics = jstep(state0, shard_batch(mesh, x), None,
                                       None, jax.random.PRNGKey(7), LR)
        return {"losses": np.asarray(metrics["losses"]),
                "acc": np.asarray(metrics["acc"]),
                # optax's first moment after one step is (1 - beta1) * grad
                "grads": _flat(jax.tree_util.tree_map(
                    lambda m: np.asarray(m) / (1.0 - cfg.beta1),
                    state1.opt_state[0].mu)),
                "params": _flat(state1.params)}
    inputs = {"cfg": _port_cfg(cfg), "params": _port_state_dict(
        cfg, params), "x": x, "lr": LR,
        "round_keys": torch.from_numpy(KEYS.astype(np.int64))}
    if scope == "global":
        inputs["draws"] = [(draws[0][r], draws[1][r])
                           for r in range(N_RANKS)]
    return inputs, ref


POOL = dict(b=2, S=16, C=8, N=4, W=14)


def _pool_case():
    """tests/test_distributed.py's global-pool case at 2 devices: the
    port's inputs, and as a function JAX's gradient of the value-weighted
    loss on the all-gathered pool and its negatives of a value-coded
    batch, per sampler."""
    b, S, C, N, W = (POOL[k] for k in ("b", "S", "C", "N", "W"))
    mesh = get_mesh(N_RANKS)
    z_full = np.random.RandomState(0).randn(N_RANKS * b, S, C).astype(
        np.float32)
    coded = np.broadcast_to((1.0 + np.arange(N_RANKS * b, dtype=np.float32))
                            [:, None, None], z_full.shape).copy()
    key = jax.random.PRNGKey(42)
    samplers = {"exact": jinfonce.sample_negatives,
                "stratified": jinfonce.sample_negatives_stratified}

    def ref():
        out = {}
        for name, sampler in samplers.items():
            def draw(z_local, d, sampler=sampler):
                pool = jax.lax.all_gather(z_local, "data", axis=0,
                                          tiled=True)
                return sampler(jax.random.fold_in(key, d), z_local, W, N,
                               pool=pool)

            def local(z_local, coded_local):
                d = jax.lax.axis_index("data")

                def loss(z):
                    neg = draw(z, d)
                    wgt = jnp.arange(neg.size, dtype=jnp.float32).reshape(
                        neg.shape)
                    return jnp.sum(wgt * neg ** 2)
                return jax.grad(loss)(z_local), draw(coded_local, d)
            grad, negs = jax.jit(jax.shard_map(
                local, mesh=mesh, in_specs=(P("data"), P("data")),
                out_specs=(P("data"), P("data")), check_vma=False))(
                z_full, coded)
            out[name] = {"grad": np.asarray(grad),
                         "negatives": np.asarray(negs)}
        return out

    # the exact sampler's draws on device d (infonce.py:115-117)
    draws = []
    for d in range(N_RANKS):
        k1, k2 = jax.random.split(jax.random.fold_in(key, d))
        draws.append(tuple(torch.from_numpy(np.asarray(
            jax.random.randint(k, (b, N, W), lo, hi)).astype(np.int64))
            for k, lo, hi in ((k1, 0, N_RANKS * b), (k2, 1, S))))
    inputs = {"z": torch.from_numpy(z_full), "coded": torch.from_numpy(coded),
              "draws": draws, "W": W, "N": N,
              "round_keys": torch.from_numpy(KEYS.astype(np.int64))}
    return inputs, ref


def _batchnorm_case():
    """tests/test_distributed.py's batchNorm case at 2 devices: the port's
    inputs, and as a function the sharded step's running statistics
    (pmean of the local updates)."""
    cfg = JCPCConfig(**BN_CFG, normMode="batchNorm")
    jmodel = jbuild_model(cfg)
    jcrit = CPCUnsupervisedCriterion(
        n_predicts=cfg.nPredicts, dim_output_ar=cfg.hiddenGar,
        dim_output_encoder=cfg.hiddenEncoder,
        negative_sampling_ext=cfg.negativeSamplingExt,
        rnn_mode=cfg.rnnMode, size_input_seq=cfg.sizeWindow // 160)
    optimizer = jopt(cfg.beta1, cfg.beta2, cfg.epsilon)
    x = np.random.RandomState(11).randn(N_RANKS * B_RANK, 1, cfg.sizeWindow
                                        ).astype(np.float32)
    x[B_RANK:] *= 3.0       # the ranks' statistics differ
    params, stats = _jax_init(jmodel, jcrit, x)
    state0 = JTrainState(params, stats, optimizer.init(params),
                         jnp.zeros((), jnp.int32))

    def ref():
        mesh = get_mesh(N_RANKS)
        jstep = jmake_train_step(jmodel, jcrit, optimizer, mesh,
                                 donate=False)
        state1, _, _ = jstep(state0, shard_batch(mesh, x), None, None,
                             jax.random.PRNGKey(5), LR)
        return {k: v.numpy() for k, v in _stats_from_jax(
            jax.tree_util.tree_map(np.asarray, state1.batch_stats)).items()}
    inputs = {"cfg": _port_cfg(cfg), "x": x, "lr": LR,
              "params": _port_state_dict(cfg, params, stats)}
    return inputs, ref


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(JAX references, port inputs, outputs of rank 0 and rank 1) of one
    pair of workers, which run while the references are computed."""
    d = tmp_path_factory.mktemp("ranks")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jstacked, "StackedTransformerHeads",
                   functools.partial(jstacked.StackedTransformerHeads,
                                     dropout=0.0))
        for fn in ("feistel_permute", "feistel_inverse"):
            orig = getattr(jinfonce, fn)
            mp.setattr(jinfonce, fn, lambda x, _k, n, orig=orig: orig(
                x, jnp.asarray(KEYS), n))
        cases = {"step": _step_case(), "step_global": _step_case("global"),
                 "pool": _pool_case(), "batchnorm": _batchnorm_case()}
        rng = np.random.RandomState(2)
        inputs = {name: case[0] for name, case in cases.items()}
        inputs["rows"] = {}
        inputs["no_graph"] = {
            "cfg": CPCConfig(**BN_CFG), "n_phones": 3,
            "x": _waves(N_RANKS * B_RANK, BN_CFG["sizeWindow"], 6),
            "labels": rng.randint(3, size=(N_RANKS * B_RANK,
                                           BN_CFG["sizeWindow"] // 160))}
        torch.save(inputs, str(d / "in.pt"))
        env = {k: v for k, v in os.environ.items()
               if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
        env["OMP_NUM_THREADS"] = "1"
        logs = [open(d / f"log_{r}.txt", "w") for r in range(N_RANKS)]
        procs = [subprocess.Popen([sys.executable, WORKER, "steps", str(d),
                                   str(r), str(N_RANKS)], env=env,
                                  stdout=logs[r], stderr=subprocess.STDOUT)
                 for r in range(N_RANKS)]
        try:
            refs = {name: case[1]() for name, case in cases.items()}
            for p in procs:
                p.wait(timeout=300)
        finally:
            for p, log in zip(procs, logs):
                p.kill()
                log.close()
    for r, p in enumerate(procs):
        assert p.returncode == 0, \
            f"rank {r}:\n{(d / f'log_{r}.txt').read_text()[-3000:]}"
    outs = [torch.load(str(d / f"out_{r}.pt"), weights_only=False)
            for r in range(N_RANKS)]
    return refs, inputs, outs


# ---- the file shards --------------------------------------------------------

@pytest.mark.parametrize("count", [1, 2, 3])
def test_shard_sequences_match_jax(count):
    """Disjoint shards covering the list (tests/test_distributed.py:6-18),
    the identity for one process, as the JAX package's."""
    seqs = [(i % 3, f"f{i}.flac") for i in range(10)]
    shards = [distributed.shard_sequences(seqs, p, count)
              for p in range(count)]
    assert shards == [jshard_sequences(seqs, p, count)
                      for p in range(count)]
    flat = [x for s in shards for x in s]
    assert sorted(flat) == sorted(seqs) and len(set(flat)) == len(flat)
    if count == 1:
        assert shards[0] == seqs


def test_world_rule_and_rows_without_a_group():
    """--nGPU on the CPU is the count asked for (-1: 1); without a group a
    rank's rows are the batch and the pool is the rank's own."""
    assert [distributed.resolve_world(n, "cpu") for n in (-1, 0, 1, 3)] == \
        [1, 1, 1, 3]
    x = torch.arange(12.0).reshape(6, 2)
    assert distributed.world() == 1 and distributed.rank_rows(x) is x
    assert distributed.gather_rows(x) is x


def test_rank_rows_in_a_group(ranks):
    """In a 2-rank group rank r takes rows [r*b, (r+1)*b) of the global
    batch, numpy or torch (shard_batch's rows of device r); None stays
    None, and a batch that does not split raises."""
    _, _, outs = ranks
    for r, o in enumerate(outs):
        got = o["rows"]
        np.testing.assert_array_equal(got["numpy"], np.arange(3 * r,
                                                              3 * r + 3))
        assert torch.equal(got["torch"], torch.arange(3 * r, 3 * r + 3))
        assert got["none"] is None
        assert "does not split over 2 ranks" in got["error"]


# ---- the step against JAX's 2-device step ----------------------------------

def _step_matches_jax(ranks, case):
    refs, _, outs = ranks
    ref = refs[case]
    got = [o[case][0] for o in outs]
    losses = np.mean([g["losses"].numpy() for g in got], axis=0)
    np.testing.assert_allclose(losses, ref["losses"], atol=1e-5)
    W = CFG40.sizeWindow // 160 - CFG40.nPredicts
    acc = np.mean([g["acc"].numpy() for g in got], axis=0)
    np.testing.assert_allclose(acc, ref["acc"],
                               atol=1.0 / (N_RANKS * B_RANK * W) + 1e-7)
    assert sorted(got[0]["grads"]) == sorted(ref["grads"])
    for name, g in got[0]["grads"].items():
        w = ref["grads"][name]
        err = np.abs(g.numpy() - w).max()
        assert err <= 1e-3 * np.abs(w).max() + 1e-8, (name, err)
        assert torch.equal(g, got[1]["grads"][name]), name
    for name, p in got[0]["params"].items():
        np.testing.assert_allclose(p.numpy(), ref["params"][name],
                                   atol=5e-6, err_msg=name)
    for a, b in zip(outs[0][case], outs[1][case]):
        assert a["digest"] == b["digest"]


def test_two_rank_step_matches_jax_two_devices(ranks):
    """One step on two ranks against JAX's make_train_step on get_mesh(2):
    the rank mean of the losses against pmean, accuracies within one
    anchor, each summed gradient leaf within 1e-3 of its largest entry
    (the gradient of the rank-summed loss, not its mean), the parameters
    after Adam within 5e-6 (tests/test_distributed.py's replay), and the
    two ranks' results bit-equal."""
    _step_matches_jax(ranks, "step")


def test_two_rank_global_pool_step_matches_jax(ranks):
    """The same step under --negative_sampling_scope global: the exact
    sampler draws from both ranks' encodings (the same injected draws on
    each rank and device, reaching rows of the other rank), K8 scatters
    the negatives' gradient into world*B*S pool rows and the pool's
    backward sums it over ranks.  Losses, accuracies, the summed
    gradients and the parameters after Adam against JAX's step with the
    all-gathered pool, within the device scope's tolerances."""
    _, inputs, _ = ranks
    for r, (b, _) in enumerate(inputs["step_global"]["draws"]):
        own = (b >= r * B_RANK) & (b < (r + 1) * B_RANK)
        assert own.any() and not own.all(), r
    _step_matches_jax(ranks, "step_global")


def test_ranks_stay_bit_identical(ranks):
    """After each of two steps the ranks' parameters are bit-equal (the
    same summed gradient, the same Adam step), while their losses, on
    other rows, differ."""
    _, _, outs = ranks
    for i in range(2):
        a, b = (o["step"][i] for o in outs)
        assert a["digest"] == b["digest"], i
        assert not torch.equal(a["losses"], b["losses"])


def test_world_one_group_is_bit_identical(tmp_path):
    """Two steps (dropout on, derived streams) in a world-1 gloo group give
    the parameters of the same two steps without a group, bit for bit:
    every collective of one rank is the identity."""
    cfg = CPCConfig(hiddenEncoder=32, hiddenGar=32, nPredicts=2,
                    negativeSamplingExt=4, sizeWindow=5120)
    x = _waves(4, cfg.sizeWindow, 6)
    runs = []
    for grouped in (False, True):
        if grouped:
            distributed.init(0, 1, "cpu", f"file://{tmp_path}/store")
        try:
            gen = torch.Generator().manual_seed(1)
            state = create_train_state(build_model(cfg, gen),
                                       build_criterion(cfg, gen), "cpu")
            step = make_train_step(state, "cpu")
            key = epoch_key(9, 0, "cpu")
            for _ in range(2):
                step(x, key=key)
            runs.append({k: v.clone() for k, v in
                         {**state.model.state_dict(),
                          **state.criterion.state_dict()}.items()})
        finally:
            distributed.close()
    for k, v in runs[0].items():
        assert torch.equal(v, runs[1][k]), k


def test_rank_streams():
    """Rank 0's dropout seed, round keys and negatives' seed are one
    device's; rank 1 draws others, at every step."""
    key = epoch_key(5, 0, "cpu")
    for step in (torch.tensor(0), torch.tensor(7)):
        r0 = step_streams(key, step, 0)
        for a, b in zip(r0, step_streams(key, step)):
            assert torch.equal(a, b)
        for a, b in zip(r0, step_streams(key, step, 1)):
            assert not torch.equal(a, b)


# ---- the global negative pool ----------------------------------------------

@pytest.mark.parametrize("sampler", ["exact", "stratified"])
def test_global_pool_gradient_matches_jax(ranks, sampler):
    """Each rank's gradient of its own value-weighted loss on the global
    pool is the gradient of the sum of every rank's loss (the pool's
    backward sums over ranks), as JAX's all_gather transpose gives it."""
    refs, _, outs = ranks
    b = POOL["b"]
    want = refs["pool"][sampler]["grad"]
    assert np.any(want != 0)
    for r, o in enumerate(outs):
        got = o["pool"][sampler]["grad"].numpy()
        np.testing.assert_allclose(got, want[r * b:(r + 1) * b], rtol=1e-6,
                                   atol=1e-6, err_msg=f"rank {r}")


@pytest.mark.parametrize("sampler", ["exact", "stratified"])
def test_global_pool_draws_other_ranks_rows(ranks, sampler):
    """Negatives of a batch whose rows hold their global index + 1: rank
    0 draws rows of rank 1, and both ranks' negatives are JAX's."""
    refs, _, outs = ranks
    b = POOL["b"]
    want = refs["pool"][sampler]["negatives"]
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o["pool"][sampler]["negatives"].numpy(),
                                      want[r * b:(r + 1) * b])
    assert outs[0]["pool"][sampler]["negatives"].max() > b


# ---- batchNorm and parameters outside the graph -----------------------------

def test_batchnorm_stats_are_the_rank_mean(ranks):
    """After a 2-rank step with --normMode batchNorm the running
    statistics are the mean of the ranks' local updates (each rank's
    forward normalised with its own batch moments), as the JAX sharded
    step's pmean (tests/test_distributed.py:104), and not any one rank's."""
    refs, _, outs = ranks
    ref = refs["batchnorm"]
    got = outs[0]["batchnorm"]
    assert sorted(ref) == sorted(k for k in got["stats"]
                                 if k.endswith(("mean", "var")))
    differs = False
    for name, want in ref.items():
        stats = got["stats"][name]
        assert torch.equal(stats, outs[1]["batchnorm"]["stats"][name])
        mean_local = (outs[0]["batchnorm"]["local"][name]
                      + outs[1]["batchnorm"]["local"][name]) / 2
        torch.testing.assert_close(stats, mean_local, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(stats.numpy(), want, rtol=1e-5,
                                   atol=1e-6, err_msg=name)
        differs |= not torch.allclose(stats, got["local"][name])
    assert differs


@pytest.mark.parametrize("case", ["none", "on_encoder"])
def test_steps_with_parameters_outside_the_graph(ranks, case):
    """--cpc_mode none (a loss with no graph) and a frame probe on the
    encoding (the AR outside the graph) take a 2-rank step without a hang:
    Adam counts the step on every parameter, the parameters outside the
    graph stay, and the ranks stay bit-equal."""
    _, _, outs = ranks
    got = [o["no_graph"][case] for o in outs]
    assert got[0]["counts"] == [1] and got[0]["digest"] == got[1]["digest"]
    moved = got[0]["moved"]
    if case == "none":
        assert not any(moved.values())
        assert float(got[0]["losses"].abs().sum()) == 0.0
    else:
        assert not any(v for k, v in moved.items() if k.startswith("gAR."))
        assert any(v for k, v in moved.items() if k.startswith("gEncoder."))


# ---- two --distributed trainer processes ------------------------------------

def test_distributed_cli_two_processes(tmp_path):
    """Two trainer processes with torchrun's variables (RANK, WORLD_SIZE,
    MASTER_ADDR / MASTER_PORT) each load their shard of the files and end
    an epoch with bit-equal parameters (tests/test_distributed.py:181-212);
    rank 0 alone writes the checkpoint."""
    sys.path.insert(0, os.path.join(REPO, "perf"))
    from soak_loader import make_tree
    db, out = str(tmp_path / "db"), str(tmp_path / "ckpt")
    make_tree(db, 8, 2, min_s=1.0, max_s=1.5, tone=True, quiet=True)
    names = sorted(os.path.splitext(f)[0] for _, _, fs in os.walk(db)
                   for f in fs if f.endswith(".wav"))
    split = tmp_path / "all.txt"
    split.write_text("\n".join(names) + "\n")
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    script = f"""
import hashlib, sys
sys.path.insert(0, {REPO!r})
from cpc_audio_tpu_torch import train
from cpc_audio_tpu_torch.parallel import distributed
run = train.run
def record(*args):
    run(*args)
    state = args[5]
    h = hashlib.sha256()
    for m in (state.model, state.criterion):
        for k, v in sorted(m.state_dict().items()):
            h.update(k.encode() + v.contiguous().numpy().tobytes())
    with open({str(tmp_path)!r} + f"/digest{{distributed.rank()}}", "w") as f:
        f.write(h.hexdigest() + " " + str(int(state.step)))
train.run = record
sys.exit(train.main(sys.argv[1:], device="cpu"))
"""
    argv = ["--pathDB", db, "--file_extension", ".wav", "--pathCheckpoint",
            out, "--pathTrain", str(split), "--pathVal", str(split),
            "--hiddenEncoder", "32", "--hiddenGar", "32", "--nPredicts", "2",
            "--negativeSamplingExt", "4", "--sizeWindow", "5120",
            "--batchSizeGPU", "2", "--nEpoch", "1", "--n_process_loader",
            "1", "--ignore_cache", "--random_seed", "3", "--distributed"]
    procs = []
    for r in range(N_RANKS):
        env = {k: v for k, v in os.environ.items()
               if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
        env.update(RANK=str(r), WORLD_SIZE=str(N_RANKS), LOCAL_RANK=str(r),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, "-c", script] + argv,
                                      env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{outs[r][-3000:]}"
    digests = [(tmp_path / f"digest{r}").read_text() for r in range(N_RANKS)]
    assert digests[0] == digests[1] and int(digests[0].split()[1]) > 0
    assert "Let's use 2 devices" in outs[0] and "Let's use" not in outs[1]
    assert sorted(os.listdir(out)) == ["checkpoint_0.pt",
                                       "checkpoint_args.json",
                                       "checkpoint_logs.json"]


def test_throughput_meter_and_profile_trace(tmp_path):
    """The epoch meter counts every rank's windows and divides by the
    devices (the JAX package's ThroughputMeter); profile_trace writes a
    torch.profiler chrome trace, and nothing without a directory."""
    from cpc_audio_tpu.utils.profiling import ThroughputMeter as JMeter
    from cpc_audio_tpu_torch.utils.profiling import (ThroughputMeter,
                                                     profile_trace)
    meters = [ThroughputMeter(4), JMeter(4)]
    for m in meters:
        m.update(32)
        m.update(32)
    assert meters[0]._windows == meters[1]._windows == 64
    summary = meters[0].summary()
    assert "windows/s/chip, 2 steps" in summary
    assert summary.split(" (")[1].split()[1] == \
        meters[1].summary().split(" (")[1].split()[1]
    with profile_trace(str(tmp_path / "trace")):
        torch.ones(4).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    with profile_trace(None):
        pass
