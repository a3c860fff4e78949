"""The port's context networks for every ``--arMode`` (GRU, RNN, LSTM,
transformer, no_ar) against the JAX package's, with the same weights
bridged through ``convert.params_from_jax`` and the same numpy inputs:
outputs, carried states and gradients.  float32 on the CPU, where the
kernel wrappers run their plain versions."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cpc_audio_tpu.config import CPCConfig as JCPCConfig
from cpc_audio_tpu.config import TrainConfig
from cpc_audio_tpu.models import build_model as jbuild_model
from cpc_audio_tpu.models.ar import CPCAR as JCPCAR
from cpc_audio_tpu.models.transformer import TransformerAR as JTransformerAR
from cpc_audio_tpu.train import get_criterion
from cpc_audio_tpu_torch import convert
from cpc_audio_tpu_torch.config import CPCConfig
from cpc_audio_tpu_torch.criterion import build_criterion
from cpc_audio_tpu_torch.feature_loader import FeatureModule
from cpc_audio_tpu_torch.models import (CPCAR, NoAr, TransformerAR,
                                        build_model)

AR_MODES = ["GRU", "LSTM", "RNN", "transformer", "no_ar"]


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _bridge(tree) -> dict:
    """A JAX gAR tree (params or gradients) as the port's state dict."""
    sd = convert.params_from_jax({"model": {"gAR": tree}})
    return {k[len("model.gAR."):]: v for k, v in sd.items()}


def _init(module, *args):
    return jax.jit(module.init)({"params": jax.random.PRNGKey(1)},
                                *args)["params"]


def _check_grads(module: torch.nn.Module, jax_grads, x_grad, x_grad_j,
                 atol: float) -> None:
    want = _bridge(jax_grads)
    got = {n: p.grad for n, p in module.named_parameters()}
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=atol,
                                   rtol=1e-4, err_msg=name)
    np.testing.assert_allclose(x_grad.numpy(), np.asarray(x_grad_j),
                               atol=atol, rtol=1e-4)


@pytest.mark.parametrize("mode", ["GRU", "RNN"])
def test_recurrent_ar_matches_jax(mode):
    """Two layers with a carried state: y, the new state and the
    gradients of every weight and of x."""
    rng = np.random.RandomState(3)
    B, T, C, H, L = 3, 11, 12, 16, 2
    x = rng.randn(B, T, C).astype(np.float32)
    h0 = (rng.randn(L, B, H) * 0.2).astype(np.float32)
    g = rng.randn(B, T, H).astype(np.float32)
    jar = JCPCAR(H, L, mode)
    params = _init(jar, jnp.asarray(x))
    (y_j, h_j), vjp = jax.vjp(
        lambda p, xx: jar.apply({"params": p}, xx, jnp.asarray(h0)),
        params, jnp.asarray(x))
    gp_j, gx_j = vjp((jnp.asarray(g), jnp.zeros_like(h_j)))
    ar = CPCAR(C, H, L, mode)
    ar.load_state_dict(_bridge(params))
    xt = _t(x).requires_grad_(True)
    y, h = ar(xt, _t(h0))
    # f32; 11 serial steps, sums in another order
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j),
                               atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_j), atol=1e-5)
    assert h.shape == (L, B, H) and not h.requires_grad   # detached carry
    (y * _t(g)).sum().backward()
    _check_grads(ar, gp_j, xt.grad, gx_j, atol=1e-4)


def test_no_ar_passes_through():
    x = torch.randn(2, 5, 8)
    hidden = torch.zeros(1)
    y, h = NoAr()(x, hidden)
    assert y is x and h is hidden
    assert NoAr().zero_state(2, torch.float32, "cpu") is None


@pytest.mark.parametrize("abspos", [False, True], ids=["relpos", "abspos"])
@pytest.mark.parametrize("path", ["xla", "pallas"])
def test_transformer_ar_matches_jax(path, abspos, monkeypatch):
    """Output and gradients (x and every weight, Krelpos included) at rate
    0, against the JAX TransformerAR through its XLA attention and through
    its Pallas kernel in interpret mode.  S = size_seq = 20 (the JAX
    kernel pads it to 24), D = 64 in 8 heads of dk = 8."""
    flag = "1" if path == "pallas" else "0"
    monkeypatch.setenv("CPC_PALLAS_ATTN", flag)
    monkeypatch.setenv("CPC_PALLAS_ATTN_INTERPRET", flag)
    rng = np.random.RandomState(11)
    B, S, D = 2, 20, 64
    x = rng.randn(B, S, D).astype(np.float32)
    g = rng.randn(B, S, D).astype(np.float32)
    jar = JTransformerAR(D, 1, S, abspos)
    params = _init(jar, jnp.asarray(x))
    y_j, vjp = jax.vjp(lambda p, xx: jar.apply({"params": p}, xx)[0],
                       params, jnp.asarray(x))
    gp_j, gx_j = vjp(jnp.asarray(g))
    ar = TransformerAR(D, 1, S, abspos)
    ar.load_state_dict(_bridge(params))
    assert hasattr(ar.layer0.multihead, "Krelpos") != abspos
    xt = _t(x).requires_grad_(True)
    y, hidden = ar(xt)
    assert hidden is None
    # f32; softmax and the 2048-wide FFN sum in another order
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j),
                               atol=1e-4)
    (y * _t(g)).sum().backward()
    _check_grads(ar, gp_j, xt.grad, gx_j, atol=2e-4)


def test_transformer_ar_drops_only_in_training():
    """train=True drops at 0.1 from the seed (and refuses to run without
    one); eval is deterministic; the same seed repeats the same output."""
    ar = TransformerAR(32, 1, 16, generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 16, 32)
    seed = torch.tensor([5])
    with torch.no_grad():
        ev = ar(x)[0]
        torch.testing.assert_close(ar(x, train=False, seed=seed)[0], ev,
                                   rtol=0, atol=0)
        tr = ar(x, train=True, seed=seed)[0]
        torch.testing.assert_close(ar(x, train=True, seed=seed)[0], tr,
                                   rtol=0, atol=0)
        assert not torch.allclose(tr, ev)
        ar.dropout = 0.0
        torch.testing.assert_close(ar(x, train=True)[0], ev, rtol=0, atol=0)
    ar.dropout = 0.1
    with pytest.raises(ValueError, match="needs a seed"):
        ar(x, train=True)


SMALL = dict(hiddenEncoder=32, hiddenGar=48, nPredicts=2,
             negativeSamplingExt=4, sizeWindow=5120, nLevelsGRU=2)


@pytest.mark.parametrize("mode", AR_MODES)
def test_build_model_for_every_ar_mode(mode):
    cfg = CPCConfig(arMode=mode, **SMALL)
    model = build_model(cfg)
    ar = model.gAR
    if mode in ("transformer", "no_ar"):
        # hiddenGar forced to hiddenEncoder; one transformer layer whatever
        # nLevelsGRU says
        assert model.config.hiddenGar == 32
        assert model.zero_state(3, "cpu") is None
        if mode == "transformer":
            assert isinstance(ar, TransformerAR) and ar.n_layers == 1
    else:
        assert isinstance(ar, CPCAR) and ar.mode == mode
        assert model.config.hiddenGar == 48
        state = model.zero_state(3, "cpu")
        states = state if mode == "LSTM" else (state,)
        assert all(s.shape == (2, 3, 48) for s in states)
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 1, 5120)
                         .astype(np.float32))
    c, z, _, hidden = model(x)
    assert c.shape == (2, 32, model.config.hiddenGar) \
        and z.shape == (2, 32, 32)


@pytest.mark.parametrize("mode,abspos", [(m, False) for m in AR_MODES]
                         + [("transformer", True)])
def test_load_jax_params_is_strict_for_every_ar_mode(mode, abspos):
    """The JAX package's parameter tree of model and criterion loads
    strictly into the port for every arMode; a tree missing one AR leaf
    is refused."""
    # the transformer heads need hiddenGar == hiddenEncoder
    jcfg = JCPCConfig(arMode=mode, abspos=abspos,
                      **dict(SMALL, hiddenGar=32))
    jmodel = jbuild_model(jcfg)
    jcrit = get_criterion(jcfg, TrainConfig(), 160, 0, 0)
    x = jnp.asarray(np.random.RandomState(1).randn(2, 1, 5120)
                    .astype(np.float32))
    params = {"model": jax.jit(jmodel.init)(
        {"params": jax.random.PRNGKey(0)}, x)["params"]}
    c, z, _, _ = jmodel.apply({"params": params["model"]}, x)
    params["criterion"] = jax.jit(
        lambda rngs, c, z: jcrit.init(rngs, c, z, None))(
        {"params": jax.random.PRNGKey(1),
         "sampling": jax.random.PRNGKey(2)}, c, z)["params"]
    cfg = CPCConfig(**jcfg.to_dict())
    model, crit = build_model(cfg), build_criterion(cfg)
    convert.load_jax_params(model, crit, params)
    c_t, z_t, _, _ = model(_t(np.asarray(x)))
    # f32 convs and the AR in another order
    np.testing.assert_allclose(c_t.detach().numpy(), np.asarray(c),
                               atol=2e-4)
    if mode != "no_ar":
        ar = dict(params["model"]["gAR"])
        ar.pop(sorted(ar)[0])
        bad = {"model": dict(params["model"], gAR=ar),
               "criterion": params["criterion"]}
        with pytest.raises(RuntimeError, match="Missing key"):
            convert.load_jax_params(build_model(cfg), build_criterion(cfg),
                                    bad)


@pytest.mark.parametrize("mode", ["GRU", "transformer"])
def test_feature_module_keeps_the_hidden_state(mode):
    """keep_hidden carries a GRU's (L, B, H) state from call to call (the
    second call differs from a fresh one) and the transformer's None."""
    model = build_model(CPCConfig(arMode=mode, **SMALL),
                        torch.Generator().manual_seed(2))
    fm = FeatureModule(model, keep_hidden=True)
    x = np.random.RandomState(4).randn(1, 1, 5120).astype(np.float32)
    first = fm(x)
    if mode == "GRU":
        assert isinstance(fm.hidden, torch.Tensor)
        assert fm.hidden.shape == (2, 1, 48)
        assert not torch.allclose(fm(x), first)
    else:
        assert fm.hidden is None
        torch.testing.assert_close(fm(x), first, rtol=0, atol=0)
    fm.reset()
    torch.testing.assert_close(fm(x), first, rtol=0, atol=0)
