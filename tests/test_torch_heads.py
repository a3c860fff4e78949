"""The port's prediction heads of every ``--rnnMode`` but the transformer
(cpc_audio_tpu_torch/criterion/prediction.py) against the JAX package's
vmapped ``PredictionNetwork``: the same weights through
``convert.params_from_jax``, the same numpy context, the predictions and
the gradient of a fixed projection of them with respect to the context
and to every head parameter.  float32 on the CPU, where the LSTM heads'
K1 wrapper runs its plain version."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cpc_audio_tpu.criterion.prediction import \
    PredictionNetwork as JPredictionNetwork
from cpc_audio_tpu_torch import convert
from cpc_audio_tpu_torch.config import CPCConfig
from cpc_audio_tpu_torch.criterion import PredictionNetwork

# K heads over B windows of W anchors; the heads read DIN channels (a
# context plus a speaker embedding) and predict DOUT
K, B, W, DIN, DOUT = 3, 2, 12, 24, 32
HEADS = ("linear", "ffd", "conv4", "conv8", "conv12", "RNN", "LSTM")


def _jax_heads(mode: str, c: np.ndarray, seed: int = 0):
    net = JPredictionNetwork(K, DOUT, mode, size_input_seq=W)
    params = net.init({"params": jax.random.PRNGKey(seed)},
                      jnp.asarray(c))["params"]
    return net, params


def _port_heads(mode: str, params) -> PredictionNetwork:
    net = PredictionNetwork(K, DOUT, mode, W, dim_input=DIN)
    sd = convert.params_from_jax({"criterion": {"wPrediction": params}})
    net.load_state_dict(convert._strip(sd, "criterion.wPrediction."))
    return net


@pytest.mark.parametrize("mode", HEADS)
def test_heads_match_jax_forward_and_gradients(mode):
    rng = np.random.RandomState(3)
    c = rng.randn(B, W, DIN).astype(np.float32)
    proj = rng.randn(K, B, W, DOUT).astype(np.float32)
    jnet, params = _jax_heads(mode, c)

    def loss(p, x):
        return jnp.sum(jnet.apply({"params": p}, x) * proj)
    want = jax.jit(jnet.apply)({"params": params}, jnp.asarray(c))
    g_params, g_c = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        params, jnp.asarray(c))

    net = _port_heads(mode, params)
    ct = torch.from_numpy(c).requires_grad_(True)
    got = net(ct)
    assert got.shape == (K, B, W, DOUT)
    # float32 products summed in another order
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    (got * torch.from_numpy(proj)).sum().backward()
    # gradients through W steps of a recurrence (RNN, LSTM) or a
    # fan_in-scaled product: 1e-4 of each leaf's largest entry
    np.testing.assert_allclose(ct.grad.numpy(), np.asarray(g_c),
                               atol=1e-4 * np.abs(g_c).max())
    want_g = convert.port_leaves({"p": g_params})
    for name, p in net.named_parameters():
        w = want_g["p." + name]
        np.testing.assert_allclose(p.grad.numpy(), w,
                                   atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("mode", HEADS)
def test_head_rows_round_trip_both_layouts(mode):
    """Every head type's rows: the JAX tree in and out (``jax_tree``
    inverts ``params_from_jax``, the recurrent heads' weights transposed
    on their last two axes only), and the reference's per-head
    ``predictors.{k}.*`` in, stacked on K and equal to the JAX package's
    own conversion of the same state dict."""
    from cpc_audio_tpu import convert as jconvert
    c = np.zeros((B, W, DIN), np.float32)
    _, params = _jax_heads(mode, c, seed=1)
    net = _port_heads(mode, params)
    tree = convert.jax_tree({f"wPrediction.{k}": v
                             for k, v in net.state_dict().items()})
    flat_in = dict(convert._flatten({"wPrediction": params}))
    flat_out = dict(convert._flatten(tree))
    assert sorted(flat_in) == sorted(flat_out)
    for k, v in flat_in.items():
        np.testing.assert_array_equal(flat_out[k], v, err_msg=k)

    ref = _reference_heads(mode, torch.Generator().manual_seed(2))
    cfg = CPCConfig(nPredicts=K, rnnMode=mode)
    got = convert.convert_prediction_network(ref, cfg)
    want = dict(convert._flatten(jconvert.convert_prediction_network(
        ref, cfg)))
    ported = convert.port_leaves(want)
    assert sorted(got) == sorted(ported)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), ported[k], err_msg=k)


def _reference_heads(mode: str, g: torch.Generator) -> dict:
    """A reference PredictionNetwork's ``predictors.{k}.*`` state dict of
    ``mode`` heads, random entries in its layouts (criterion.py:44-118)."""
    def r(*shape):
        return torch.randn(shape, generator=g)
    one = {"linear": lambda: {"weight": r(DOUT, DIN)},
           "ffd": lambda: {f"{lin}.module.{p}": r(*s) for lin, din in
                           (("lin1", DIN), ("lin2", DOUT))
                           for p, s in (("weight", (DOUT, din)),
                                        ("bias", (DOUT,)))},
           "RNN": lambda: _cell(r, 1),
           "LSTM": lambda: _cell(r, 4)}
    if mode.startswith("conv"):
        k = int(mode[4:])
        make = lambda: {"module.module.weight": r(DOUT, DIN, k),  # noqa
                        "module.module.bias": r(DOUT)}
    else:
        make = one[mode]
    return {f"predictors.{i}.{name}": v for i in range(K)
            for name, v in make().items()}


def _cell(r, G: int) -> dict:
    return {"weight_ih_l0": r(G * DOUT, DIN),
            "weight_hh_l0": r(G * DOUT, DOUT),
            "bias_ih_l0": r(G * DOUT), "bias_hh_l0": r(G * DOUT)}
