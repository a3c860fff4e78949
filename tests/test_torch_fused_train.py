"""The port's fused-layer train path against the JAX package's: both
packages read the same two switches, ``CPC_ATTN_BLOCK=1`` (the heads' whole
attention block, K6) and ``CPC_PALLAS_CONV=1`` (the encoder's conv +
ChannelNorm + ReLU layers, K7).  The JAX side runs its Pallas kernels in
interpret mode (``CPC_PALLAS_ATTN=1``, ``CPC_PALLAS_ATTN_INTERPRET=1``,
``CPC_PALLAS_CONV_INTERPRET=1``), the port its plain versions, on the
config, batch, round keys and tolerances of tests/test_torch_train.py."""

import functools

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
from cpc_audio_tpu_torch.convert import load_jax_params, params_from_jax
from cpc_audio_tpu_torch.criterion import build_criterion
from cpc_audio_tpu_torch.models import build_model
from cpc_audio_tpu_torch.parallel.train_step import (create_train_state,
                                                     make_train_step)

CFG = CPCConfig(hiddenEncoder=128, hiddenGar=128, nPredicts=4,
                negativeSamplingExt=16, sizeWindow=20480)
B = 2
LR = 2e-4
KEYS = np.array([0x12345678, 0x9ABCDEF0, 0x0F1E2D3C, 0xDEADBEEF, 0x2468ACE0],
                np.uint32)
SWITCHES = ("CPC_ATTN_BLOCK", "CPC_PALLAS_CONV")
INTERPRET = ("CPC_PALLAS_ATTN", "CPC_PALLAS_ATTN_INTERPRET",
             "CPC_PALLAS_CONV_INTERPRET")


@pytest.fixture
def fused(monkeypatch):
    for var in SWITCHES + INTERPRET:
        monkeypatch.setenv(var, "1")


def _waves(batch, n, seed):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16000.0
    f0 = rng.uniform(100, 400, size=(batch, 1))
    x = 0.3 * np.sin(2 * np.pi * f0 * t) + 0.05 * rng.randn(batch, n)
    return x[:, None, :].astype(np.float32)


def _flat(tree):
    return {k: v.numpy() for k, v in params_from_jax(tree).items()}


def _shapes(module):
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}


def test_switches_select_the_fused_layers(fused, monkeypatch):
    """build_model and build_criterion read the two switches: the encoder
    fuses layers 1-4, the heads run the block; without the switches
    neither does, and the parameters are the same either way."""
    model, crit = build_model(CFG), build_criterion(CFG)
    assert model.gEncoder.fused_layers(CFG.sizeWindow) == (1, 2, 3, 4)
    assert crit.wPrediction.heads.layer0.multihead.attention_block
    for var in SWITCHES:
        monkeypatch.delenv(var)
    plain_model, plain_crit = build_model(CFG), build_criterion(CFG)
    assert plain_model.gEncoder.fused_layers(CFG.sizeWindow) == ()
    assert not plain_crit.wPrediction.heads.layer0.multihead.attention_block
    assert _shapes(model) == _shapes(plain_model)
    assert _shapes(crit) == _shapes(plain_crit)


def _jax_param_shapes(x):
    jmodel = jbuild_model(CFG)
    jcrit = get_criterion(CFG, TrainConfig(), 160, 0, 0)
    m = jax.eval_shape(lambda x: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, x)["params"], x)
    c, z, _, _ = jax.eval_shape(
        lambda p, x: jmodel.apply({"params": p}, x), m, x)
    cr = jax.eval_shape(lambda c, z: jcrit.init(
        {"params": jax.random.PRNGKey(1), "sampling": jax.random.PRNGKey(2)},
        c, z, None)["params"], c, z)
    return {"model": m, "criterion": cr}


def test_jax_parameter_tree_loads_unchanged(fused, monkeypatch):
    """The JAX package declares the same parameters under both switches
    (encoder.py:193, stacked_heads.py:103-107): the tree its fused path
    initialises has the shapes of its default path's, and loads as it is
    into the port's fused model and criterion."""
    x = jnp.asarray(_waves(B, CFG.sizeWindow, 4))
    fused_tree = _jax_param_shapes(x)
    for var in SWITCHES:
        monkeypatch.delenv(var)
    plain_tree = _jax_param_shapes(x)
    assert jax.tree_util.tree_structure(fused_tree) == \
        jax.tree_util.tree_structure(plain_tree)
    assert [a.shape for a in jax.tree_util.tree_leaves(fused_tree)] == \
        [a.shape for a in jax.tree_util.tree_leaves(plain_tree)]
    for var in SWITCHES:
        monkeypatch.setenv(var, "1")
    rng = np.random.RandomState(0)
    values = jax.tree_util.tree_map(
        lambda a: rng.randn(*a.shape).astype(np.float32), fused_tree)
    model, crit = build_model(CFG), build_criterion(CFG)
    load_jax_params(model, crit, values)             # strict
    flat = _flat(values)
    for prefix, module in (("model.", model), ("criterion.", crit)):
        for name, p in module.state_dict().items():
            np.testing.assert_array_equal(p.numpy(), flat[prefix + name])


def test_fused_train_step_matches_jax(fused, monkeypatch):
    """Losses, accuracies, every gradient leaf and the parameters after one
    Adam step, both packages on their fused path; the JAX heads' dropout is
    patched to 0 here only, the port's heads' rate set to 0, and the round
    keys injected into the JAX sampler, as tests/test_torch_train.py
    does."""
    monkeypatch.setattr(jstacked, "StackedTransformerHeads",
                        functools.partial(jstacked.StackedTransformerHeads,
                                          dropout=0.0))
    for fn in ("feistel_permute", "feistel_inverse"):
        orig = getattr(jinfonce, fn)
        monkeypatch.setattr(jinfonce, fn, lambda x, _k, n, orig=orig: orig(
            x, jnp.asarray(KEYS), n))
    jmodel = jbuild_model(CFG)
    jcrit = get_criterion(CFG, TrainConfig(), 160, 0, 0)
    x = _waves(B, CFG.sizeWindow, 4)
    params = {"model": jax.jit(jmodel.init)(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(x))["params"]}
    c, z, _, _ = jmodel.apply({"params": params["model"]}, jnp.asarray(x))
    params["criterion"] = jax.jit(
        lambda rngs, c, z: jcrit.init(rngs, c, z, None))(
        {"params": jax.random.PRNGKey(1),
         "sampling": jax.random.PRNGKey(2)}, c, z)["params"]
    optimizer = jopt(CFG.beta1, CFG.beta2, CFG.epsilon)
    state0 = JTrainState(params, {}, optimizer.init(params),
                         jnp.zeros((), jnp.int32))
    mesh = get_mesh(1)
    jstep = jmake_train_step(jmodel, jcrit, optimizer, mesh, donate=False)
    state1, _, metrics_j = jstep(state0, shard_batch(mesh, x), None, None,
                                 jax.random.PRNGKey(7), LR)
    # optax's first moment after one step is (1 - beta1) * grad
    grads_j = _flat(jax.tree_util.tree_map(
        lambda m: np.asarray(m) / (1.0 - CFG.beta1), state1.opt_state[0].mu))
    params0 = _flat(params)
    params1_j = _flat(state1.params)

    model, crit = build_model(CFG), build_criterion(CFG)
    assert model.gEncoder.fused_layers(CFG.sizeWindow) == (1, 2, 3, 4)
    assert crit.wPrediction.heads.layer0.multihead.attention_block
    load_jax_params(model, crit, params)
    crit.wPrediction.heads.dropout = 0.0
    state = create_train_state(model, crit, "cpu", LR, CFG.beta1, CFG.beta2,
                               CFG.epsilon)
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
    W = CFG.sizeWindow // 160 - CFG.nPredicts
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
        # Adam's first step: +-lr wherever |g| >> eps, as in
        # tests/test_torch_train.py
        step_t = sd[name].numpy() - params0[name]
        step_j = p1 - params0[name]
        big = np.abs(grads_j[name]) > 1e-3 * np.abs(grads_j[name]).max()
        np.testing.assert_allclose(step_t[big], step_j[big],
                                   atol=1e-3 * LR, err_msg=name)
        assert np.abs(step_t - step_j).max() <= LR * 1.001, name
