"""The port's eval slice end to end against the JAX package: the same
weights (bridged by ``convert.load_jax_params``), the same waveforms and
the same Feistel round keys give the same z, c, head outputs, losses and
accuracies, and the same extracted features.  float32 on the CPU."""

import wave

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cpc_audio_tpu import feature_loader as jfl
from cpc_audio_tpu.config import CPCConfig, TrainConfig
from cpc_audio_tpu.criterion import infonce as jinfonce
from cpc_audio_tpu.models import build_model as jbuild_model
from cpc_audio_tpu.train import get_criterion
from cpc_audio_tpu_torch import feature_loader as tfl
from cpc_audio_tpu_torch.convert import load_jax_params
from cpc_audio_tpu_torch.criterion import build_criterion
from cpc_audio_tpu_torch.models import build_model
from cpc_audio_tpu_torch.parallel.train_step import make_val_step

# D = 128 so that the JAX fused tail applies (it needs D % 128 == 0);
# W = 124 > 64 so that its attention pads to 128; B*S = 256 and 16
# negatives resolve `auto` to the stratified sampler.
CFG = CPCConfig(hiddenEncoder=128, hiddenGar=128, nPredicts=4,
                negativeSamplingExt=16, sizeWindow=20480)
B = 2
KEYS = np.array([0x12345678, 0x9ABCDEF0, 0x0F1E2D3C, 0xDEADBEEF, 0x2468ACE0],
                np.uint32)


def _waves(batch, n, seed):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16000.0
    f0 = rng.uniform(100, 400, size=(batch, 1))
    x = 0.3 * np.sin(2 * np.pi * f0 * t) + 0.05 * rng.randn(batch, n)
    return x[:, None, :].astype(np.float32)


@pytest.fixture(scope="module")
def jax_slice():
    model = jbuild_model(CFG)
    crit = get_criterion(CFG, TrainConfig(), 160, 0, 0)
    x = jnp.asarray(_waves(B, CFG.sizeWindow, 0))
    # jitted inits: an eager flax init here takes seconds per op chain
    params = {"model": jax.jit(model.init)(
        {"params": jax.random.PRNGKey(0)}, x)["params"]}
    c, z, _, _ = model.apply({"params": params["model"]}, x)
    params["criterion"] = jax.jit(
        lambda rngs, c, z: crit.init(rngs, c, z, None))(
        {"params": jax.random.PRNGKey(1),
         "sampling": jax.random.PRNGKey(2)}, c, z)["params"]
    return model, crit, params


@pytest.mark.parametrize("path", ["pallas", "xla"])
def test_eval_slice_matches_jax(jax_slice, path, monkeypatch):
    """'pallas': the JAX package's attention and tail kernels in interpret
    mode; 'xla': its plain path.  Either way the port must agree."""
    flag = "1" if path == "pallas" else "0"
    for var in ("CPC_PALLAS_ATTN", "CPC_PALLAS_FFN"):
        monkeypatch.setenv(var, flag)
        monkeypatch.setenv(var + "_INTERPRET", flag)
    # inject the round keys into the JAX sampler (its own come from threefry)
    for fn in ("feistel_permute", "feistel_inverse"):
        orig = getattr(jinfonce, fn)
        monkeypatch.setattr(jinfonce, fn,
                            lambda x, _k, n, orig=orig: orig(
                                x, jnp.asarray(KEYS), n))
    jmodel, jcrit, params = jax_slice
    x = _waves(B, CFG.sizeWindow, 1)
    c_j, z_j, _, _ = jmodel.apply({"params": params["model"]},
                                  jnp.asarray(x))
    W = c_j.shape[1] - CFG.nPredicts
    crit_vars = {"params": params["criterion"]}
    preds_j = jcrit.apply(crit_vars, c_j[:, :W],
                          method=lambda m, c: m.w_prediction(c))
    losses_j, acc_j = jcrit.apply(crit_vars, c_j, z_j, None,
                                  rngs={"sampling": jax.random.PRNGKey(9)})

    model, crit = build_model(CFG), build_criterion(CFG)
    load_jax_params(model, crit, params)
    with torch.no_grad():
        c, z, _, _ = model(torch.from_numpy(x))
        preds = crit.wPrediction(c[:, :W])
    _, metrics = make_val_step(model, crit, "cpu")(
        x, round_keys=torch.from_numpy(KEYS.astype(np.int64)))

    # f32 throughout; tolerances cover sums taken in another order
    np.testing.assert_allclose(z.numpy(), np.asarray(z_j), atol=2e-5)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_j), atol=2e-5)
    np.testing.assert_allclose(preds.numpy(), np.asarray(preds_j),
                               atol=2e-4)
    np.testing.assert_allclose(metrics["losses"].numpy(),
                               np.asarray(losses_j), atol=1e-5)
    # an anchor whose positive and best negative are within f32 noise may
    # flip: at most one of the B*W anchors per step
    np.testing.assert_allclose(metrics["acc"].numpy(), np.asarray(acc_j),
                               atol=1.0 / (B * W) + 1e-7)


def test_val_step_keys_and_hidden():
    model, crit = build_model(CFG), build_criterion(CFG)
    step = make_val_step(model, crit, torch.device("cpu"))
    x = _waves(B, CFG.sizeWindow, 2)
    hid, m1 = step(x, generator=torch.Generator().manual_seed(5))
    _, m2 = step(x, generator=torch.Generator().manual_seed(5))
    _, m3 = step(x, generator=torch.Generator().manual_seed(6))
    assert m1["losses"].shape == (CFG.nPredicts,)
    assert m1["acc"].shape == (CFG.nPredicts,)
    assert torch.isfinite(m1["losses"]).all()
    torch.testing.assert_close(m1["losses"], m2["losses"], rtol=0, atol=0)
    assert not torch.equal(m1["losses"], m3["losses"])   # other negatives
    assert [tuple(h.shape) for h in hid] == [(1, B, CFG.hiddenGar)] * 2


def _write_wav(path, samples):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(samples, -1, 1) * 32767).astype("<i2")
                      .tobytes())


@pytest.mark.parametrize("opts", [
    dict(keep_hidden=True, seq_norm=True, strict=False, get_encoded=False),
    dict(keep_hidden=False, seq_norm=False, strict=True, get_encoded=True)])
def test_build_feature_matches_jax(tmp_path, opts):
    cfg = CPCConfig(hiddenEncoder=32, hiddenGar=32)
    path = tmp_path / "a.wav"
    _write_wav(path, _waves(1, 40000, 3)[0, 0])    # 2.5 chunks of 16000
    jmodel = jbuild_model(cfg)
    jvars = jmodel.init({"params": jax.random.PRNGKey(3)},
                        jnp.zeros((1, 1, 16000)))
    kw = dict(get_encoded=opts["get_encoded"],
              keep_hidden=opts["keep_hidden"])
    build = dict(strict=opts["strict"], max_size_seq=16000,
                 seq_norm=opts["seq_norm"])
    want = jfl.build_feature(jfl.FeatureModule(jmodel, jvars, **kw),
                             str(path), **build)
    model = build_model(cfg)
    load_jax_params(model, torch.nn.Module(), {"model": jvars["params"]})
    got = tfl.build_feature(tfl.FeatureModule(model, **kw), str(path),
                            **build)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert got.shape[1] == 40000 // 160
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("frames", [1, 5])
def test_seq_normalization_matches_jax(frames):
    """One frame has no unbiased variance: both packages give zeros."""
    x = np.random.RandomState(frames).randn(1, frames, 8).astype(np.float32)
    got = tfl.seq_normalization(torch.from_numpy(x)).numpy()
    want = np.asarray(jfl.seq_normalization(jnp.asarray(x)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5)
