"""The port's non-default variants against the JAX package: the
instanceNorm / ID / batchNorm conv encoders, the MFCC and LFB encoders,
the bidirectional ARs, ``--cpc_mode reverse`` and ``none``, the speaker
embedding, the dtypes of c and z in bf16, and the converter rows of each
(the reference layout and the JAX tree, in and out).  float32 on the CPU,
weights bridged by ``convert.params_from_jax``, inputs from a numpy
seed."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cpc_audio_tpu import convert as jconvert
from cpc_audio_tpu.config import CPCConfig as JCPCConfig
from cpc_audio_tpu.config import TrainConfig as JTrainConfig
from cpc_audio_tpu.models import build_model as jbuild_model
from cpc_audio_tpu.models.ar import BiDIRAR as JBiDIRAR
from cpc_audio_tpu.models.ar import BiDIRARTangled as JBiDIRARTangled
from cpc_audio_tpu.models.encoder import CPCEncoder as JEncoder
from cpc_audio_tpu.models.encoder import LFBEncoder as JLFB
from cpc_audio_tpu.models.encoder import MFCCEncoder as JMFCC
from cpc_audio_tpu.parallel import get_mesh, shard_batch
from cpc_audio_tpu.parallel.train_step import TrainState as JTrainState
from cpc_audio_tpu.parallel.train_step import make_optimizer as jopt
from cpc_audio_tpu.parallel.train_step import \
    make_train_step as jmake_train_step
from cpc_audio_tpu.train import get_criterion as jget_criterion
from cpc_audio_tpu_torch import convert
from cpc_audio_tpu_torch.config import CPCConfig
from cpc_audio_tpu_torch.criterion import NoneCriterion, build_criterion
from cpc_audio_tpu_torch.models import (BiDIRAR, BiDIRARTangled, CPCEncoder,
                                        LFBEncoder, MFCCEncoder, build_model)
from cpc_audio_tpu_torch.parallel.train_step import (create_train_state,
                                                     make_train_step)

C = 32


def _waves(batch, n, seed):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16000.0
    f0 = rng.uniform(100, 400, size=(batch, 1))
    x = 0.3 * np.sin(2 * np.pi * f0 * t) + 0.05 * rng.randn(batch, n)
    return x[:, None, :].astype(np.float32)


def _load(module, params, prefix, batch_stats=None):
    """A JAX sub-tree at ``model.<prefix>`` into a port module."""
    sd = convert.params_from_jax({"model": {prefix: params}})
    sd = convert._strip(sd, f"model.{prefix}.")
    stats = convert._stats_from_jax({prefix: batch_stats or {}})
    sd.update(convert._strip(stats, f"{prefix}."))
    for k, v in module.state_dict().items():
        sd.setdefault(k, v)
    module.load_state_dict(sd)


@pytest.mark.parametrize("norm", ["instanceNorm", "ID", "batchNorm"])
def test_encoder_norms_match_jax(norm):
    """Each --normMode's encoder, in training (batchNorm: batch statistics,
    and the running statistics after the step) and then in eval (batchNorm:
    the running statistics), the gradient of every parameter too."""
    rng = np.random.RandomState(1)
    x = _waves(2, 3200, 1)
    proj = rng.randn(2, 20, C).astype(np.float32)
    jenc = JEncoder(C, norm)
    variables = jenc.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x))
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    # non-trivial running statistics to start from
    stats = jax.tree_util.tree_map(
        lambda s: s + 0.1 * rng.rand(*s.shape).astype(np.float32), stats)

    def loss(p):
        v = {"params": p, "batch_stats": stats} if stats else {"params": p}
        y, upd = jenc.apply(v, jnp.asarray(x), train=True,
                            mutable=["batch_stats"])
        return jnp.sum(y * proj), (y, upd)
    (_, (want, upd)), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)

    enc = CPCEncoder(C, norm_mode=norm)
    _load(enc, params, "gEncoder", stats)
    got = enc(torch.from_numpy(x), train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)
    (got * torch.from_numpy(proj)).sum().backward()
    want_g = convert.port_leaves({"gEncoder": g})
    # 1e-4 of the largest gradient entry of the encoder: a conv bias just
    # before an instance or batch norm has an exact gradient of 0 (the
    # norm removes it), of which both sides hold only float32 noise
    scale = max(np.abs(w).max() for w in want_g.values())
    for name, p in enc.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[f"gEncoder.{name}"],
                                   atol=1e-4 * scale, err_msg=name)
    new_stats = upd.get("batch_stats", {})
    if norm == "batchNorm":
        # flax's update: momentum 0.9, the biased batch variance
        for name, v in convert._stats_from_jax(
                {"gEncoder": new_stats}).items():
            np.testing.assert_allclose(
                enc.state_dict()[name[len("gEncoder."):]].numpy(),
                v.numpy(), atol=1e-6, err_msg=name)
    want_eval = jax.jit(jenc.apply)(
        {"params": params, "batch_stats": new_stats} if new_stats
        else {"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got_eval = enc(torch.from_numpy(x))
    np.testing.assert_allclose(got_eval.numpy(), np.asarray(want_eval),
                               atol=1e-5)


@pytest.mark.parametrize("kind", ["mfcc", "lfb"])
def test_feature_encoders_match_jax(kind):
    """MFCC (no parameters) and LFB (the conv's gradient too)."""
    x = _waves(2, 5120, 2)
    jenc = JMFCC(C) if kind == "mfcc" else JLFB(C)
    params = jenc.init({"params": jax.random.PRNGKey(1)},
                       jnp.asarray(x)).get("params", {})
    proj = np.random.RandomState(3).randn(2, 32, C).astype(np.float32)

    def loss(p):
        return jnp.sum(jenc.apply({"params": p}, jnp.asarray(x)) * proj)
    want = jax.jit(jenc.apply)({"params": params}, jnp.asarray(x))
    enc = MFCCEncoder(C) if kind == "mfcc" else LFBEncoder(C)
    _load(enc, params, "gEncoder")
    got = enc(torch.from_numpy(x))
    assert got.shape == (2, 32, C) and got.dtype == torch.float32
    # MFCC: dB values up to ~100 through an FFT and a DCT in float32
    atol = 1e-3 if kind == "mfcc" else 1e-5
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=1e-5)
    if kind == "lfb":
        g = jax.jit(jax.grad(loss))(params)
        (got * torch.from_numpy(proj)).sum().backward()
        for name, p in enc.named_parameters():
            w = convert.port_leaves({"gEncoder": g})[f"gEncoder.{name}"]
            np.testing.assert_allclose(p.grad.numpy(), w,
                                       atol=1e-4 * np.abs(w).max(),
                                       err_msg=name)


@pytest.mark.parametrize("window", [5120, 20480])
@pytest.mark.parametrize("kind", ["cpc", "mfcc", "lfb"])
def test_encoders_give_size_window_over_160_frames(kind, window):
    """Every encoder gives sizeWindow // 160 frames at a multiple of 160
    samples, as the JAX encoders do: the port's constant 160 is theirs."""
    jenc = {"cpc": JEncoder, "mfcc": JMFCC, "lfb": JLFB}[kind](8)
    x = jnp.zeros((1, 1, window), jnp.float32)
    shapes = jax.eval_shape(lambda: jenc.init_with_output(
        {"params": jax.random.PRNGKey(0)}, x)[0])
    enc = {"cpc": CPCEncoder, "mfcc": MFCCEncoder, "lfb": LFBEncoder}[kind](8)
    with torch.no_grad():
        got = enc(torch.zeros(1, 1, window))
    assert got.shape == shapes.shape == (1, window // 160, 8)


DTYPE_CASES = [("cpc", "layerNorm"), ("cpc", "instanceNorm"), ("cpc", "ID"),
               ("cpc", "batchNorm"), ("mfcc", "layerNorm"),
               ("lfb", "layerNorm")]


@pytest.mark.parametrize("encoder,norm", DTYPE_CASES)
def test_bf16_c_and_z_dtypes_match_jax(encoder, norm):
    """In bf16 each encoder and norm gives c and z the JAX package's
    dtypes: bf16, but float32 from MFCC, LFB and batchNorm (flax's module
    infers float32 from its parameters), whose AR then runs float32."""
    kw = dict(hiddenEncoder=16, hiddenGar=16, sizeWindow=3200, arMode="GRU",
              encoder_type=encoder, normMode=norm, compute_dtype="bfloat16")
    jmodel = jbuild_model(JCPCConfig(**kw))
    x = jnp.zeros((2, 1, 3200), jnp.float32)

    def run():
        v = jmodel.init({"params": jax.random.PRNGKey(0)}, x)
        return jmodel.apply(v, x)[:2]
    want = [str(a.dtype) for a in jax.eval_shape(run)]
    model = build_model(CPCConfig(**kw))
    with torch.no_grad():
        c, z, _, _ = model(torch.from_numpy(_waves(2, 3200, 4)))
    assert [str(c.dtype)[6:], str(z.dtype)[6:]] == want


@pytest.mark.parametrize("kind", ["tangled", "stacks"])
def test_bidirectional_ars_match_jax(kind):
    """BiDIRARTangled and BiDIRAR, two layers: output and input gradient,
    their GRU layers on K4's plain version; the reference state dict's
    rows (ARNet, netForward / netBackward) against the JAX converter's."""
    rng = np.random.RandomState(5)
    B, T, D, H = 2, 9, 12, 16
    x = rng.randn(B, T, D).astype(np.float32)
    proj = rng.randn(B, T, H).astype(np.float32)
    jar = (JBiDIRARTangled if kind == "tangled" else JBiDIRAR)(H, 2)
    params = jar.init({"params": jax.random.PRNGKey(2)},
                      jnp.asarray(x))["params"]

    def loss(xx):
        return jnp.sum(jar.apply({"params": params}, xx)[0] * proj)
    want = jax.jit(jar.apply)({"params": params}, jnp.asarray(x))[0]
    g = jax.jit(jax.grad(loss))(jnp.asarray(x))
    ar = (BiDIRARTangled if kind == "tangled" else BiDIRAR)(D, H, 2)
    sd = convert.params_from_jax({"m": params})
    ar.load_state_dict(convert._strip(sd, "m."))
    xt = torch.from_numpy(x).requires_grad_(True)
    got, hidden = ar(xt)
    assert hidden is None and got.shape == (B, T, H)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)
    (got * torch.from_numpy(proj)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g), atol=1e-5)

    # the reference layout: random entries, the JAX converter's reading
    gen = torch.Generator().manual_seed(6)
    ref = {f"{name}": torch.randn(v.shape, generator=gen)
           for name, v in _reference_bidir(kind, ar).items()}
    port = (convert.convert_bidir_tangled if kind == "tangled"
            else convert.convert_bidir)(ref)
    jtree = (jconvert.convert_bidir_tangled(ref, 2) if kind == "tangled"
             else jconvert.convert_bidir(ref, 2))
    want_sd = {k: v for k, v in convert.port_leaves(jtree).items()}
    assert sorted(port) == sorted(want_sd) == sorted(ar.state_dict())
    for k, v in port.items():
        np.testing.assert_array_equal(v.numpy(), want_sd[k], err_msg=k)
    with pytest.raises(ValueError, match="no --arMode builds one"):
        convert.convert_ar(ref, CPCConfig(arMode="GRU"))


def _reference_bidir(kind, ar) -> dict:
    """The reference's keys for the port's bidirectional AR ``ar``."""
    out = {}
    for name, v in ar.state_dict().items():
        if kind == "tangled":          # layer{l}_{fwd,bwd}.{p}_{g}
            layer, leaf = name.split(".")
            l, d = layer[5:].split("_")
            out[f"ARNet.{leaf}_l{l}" + ("_reverse" if d == "bwd" else "")] \
                = v
        else:                           # {net}.layer{l}.{p}_{g}
            net, layer, leaf = name.split(".")
            out[f"{net}.{leaf}_l{layer[5:]}"] = v
    return out


# ---------------------------------------------------------------------------
# Train steps against the JAX package's
# ---------------------------------------------------------------------------

KEYS = np.array([0x12345678, 0x9ABCDEF0, 0x0F1E2D3C, 0xDEADBEEF, 0x2468ACE0],
                np.uint32)
LR = 2e-4
STEP_CASES = {
    # the chip path's variant flags at a small width: LSTM heads, the
    # reversed AR and criterion, batchNorm and a speaker embedding
    "reverse LSTM batchNorm speakers": dict(
        cpc_mode="reverse", rnnMode="LSTM", normMode="batchNorm",
        speakerEmbedding=8),
    "none": dict(cpc_mode="none"),
    "mfcc ffd speakers": dict(encoder_type="mfcc", rnnMode="ffd",
                              speakerEmbedding=4),
    "lfb conv4 GRU": dict(encoder_type="lfb", rnnMode="conv4",
                          arMode="GRU"),
    "instanceNorm RNN": dict(normMode="instanceNorm", rnnMode="RNN",
                             arMode="GRU"),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_variant_train_step_matches_jax(case, monkeypatch):
    """One make_train_step step of each package on the same weights,
    batch, speaker labels and Feistel round keys: losses, accuracies, every
    gradient leaf, batchNorm's running statistics after the step and the
    parameters after Adam.  Under --cpc_mode none the losses are one zero,
    the parameters do not move and Adam counts the step."""
    from cpc_audio_tpu.criterion import infonce as jinfonce
    for fn in ("feistel_permute", "feistel_inverse"):
        orig = getattr(jinfonce, fn)
        monkeypatch.setattr(jinfonce, fn, lambda x, _k, n, orig=orig: orig(
            x, jnp.asarray(KEYS), n))
    kw = {**dict(hiddenEncoder=C, hiddenGar=C, nPredicts=2,
                 negativeSamplingExt=4, sizeWindow=5120, arMode="LSTM"),
          **STEP_CASES[case]}
    jcfg, cfg = JCPCConfig(**kw), CPCConfig(**kw)
    B, n_speakers = 2, 3
    labels = np.array([2, 0], np.int32)
    use_labels = cfg.speakerEmbedding > 0
    jmodel = jbuild_model(jcfg)
    jcrit = jget_criterion(jcfg, JTrainConfig(), 160, n_speakers, 0)
    x = _waves(B, cfg.sizeWindow, 4)
    variables = jax.jit(lambda x: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, x, train=True))(jnp.asarray(x))
    params = {"model": variables["params"]}
    stats = {"model": variables["batch_stats"]} \
        if "batch_stats" in variables else {}
    c, z, _, _ = jmodel.apply(dict(variables), jnp.asarray(x))
    lab = jnp.asarray(labels) if use_labels else None
    params["criterion"] = jcrit.init(
        {"params": jax.random.PRNGKey(1), "sampling": jax.random.PRNGKey(2)},
        c, z, lab).get("params", {})
    optimizer = jopt(cfg.beta1, cfg.beta2, cfg.epsilon)
    state0 = JTrainState(params, stats, optimizer.init(params),
                         jnp.zeros((), jnp.int32))
    mesh = get_mesh(1)
    jstep = jmake_train_step(jmodel, jcrit, optimizer, mesh, donate=False)
    state1, _, metrics_j = jstep(
        state0, shard_batch(mesh, x),
        shard_batch(mesh, labels) if use_labels else None, None,
        jax.random.PRNGKey(7), LR)
    mu = convert.port_leaves(state1.opt_state[0].mu)
    grads_j = {k: np.asarray(v) / (1.0 - cfg.beta1) for k, v in mu.items()}
    params0 = convert.port_leaves(params)
    params1_j = convert.port_leaves(state1.params)

    model = build_model(cfg)
    crit = build_criterion(cfg, n_speakers=n_speakers)
    convert.load_jax_params(model, crit, params, stats)
    state = create_train_state(model, crit, "cpu", LR, cfg.beta1, cfg.beta2,
                               cfg.epsilon)
    _, metrics = make_train_step(state, "cpu")(
        x, round_keys=torch.from_numpy(KEYS.astype(np.int64)),
        labels=labels if use_labels else None)
    np.testing.assert_allclose(metrics["losses"].numpy(),
                               np.asarray(metrics_j["losses"]), atol=1e-5)
    np.testing.assert_allclose(metrics["acc"].numpy(),
                               np.asarray(metrics_j["acc"]), atol=0.02)
    sd = {**{"model." + k: v for k, v in model.state_dict().items()},
          **{"criterion." + k: v for k, v in crit.state_dict().items()}}
    named = {f"{prefix}.{n}": p for prefix, mod in
             (("model", model), ("criterion", crit))
             for n, p in mod.named_parameters()}
    assert sorted(named) == sorted(grads_j)
    if cfg.cpc_mode == "none":
        assert isinstance(crit, NoneCriterion)
        assert metrics["losses"].tolist() == [0.0]
        for name, p in named.items():
            assert np.array_equal(p.detach().numpy(), params0[name])
            st = state.optimizer.state[p]
            assert float(st["step"]) == 1.0
            assert not st["exp_avg"].any() and not st["exp_avg_sq"].any()
    top = max(np.abs(w).max() for w in grads_j.values())
    for name, p in named.items():
        # each leaf within 1e-3 of its largest entry, float32 sums in
        # another order through the window's recurrences; plus 1e-5 of the
        # step's largest entry: a conv bias just before an instance or
        # batch norm has an exact gradient of 0, of which both sides hold
        # only float32 noise
        g, w = p.grad.numpy(), grads_j[name]
        assert np.abs(g - w).max() <= 1e-3 * np.abs(w).max() + 1e-5 * top, \
            name
        # Adam's first step moves an entry by lr * g / (|g| + eps): within
        # 1e-3 lr where the gradient is not noise, else by up to 2 lr
        step_t = sd[name].numpy() - params0[name]
        step_j = params1_j[name] - params0[name]
        big = np.abs(w) > 1e-3 * top
        np.testing.assert_allclose(step_t[big], step_j[big], atol=1e-3 * LR,
                                   err_msg=name)
        assert np.abs(step_t - step_j).max() <= 2 * LR * 1.001, name
    for name, v in convert._stats_from_jax(state1.batch_stats).items():
        np.testing.assert_allclose(sd["model." + name].numpy(), v.numpy(),
                                   atol=1e-6, err_msg=name)


# ---------------------------------------------------------------------------
# Converter rows
# ---------------------------------------------------------------------------

ROW_CASES = [("cpc", "instanceNorm"), ("cpc", "batchNorm"), ("cpc", "ID"),
             ("lfb", "layerNorm"), ("mfcc", "layerNorm")]


@pytest.mark.parametrize("encoder,norm", ROW_CASES)
def test_encoder_rows_round_trip_both_layouts(encoder, norm):
    """The encoder's and the speaker embedding's rows: the reference
    layout out and in (``export_cpc_model`` / ``convert_cpc_model``,
    batchNorm's running statistics included) and equal to the JAX
    package's reading of that export; the JAX tree out and in
    (``jax_tree``, ``jax_batch_stats``, ``load_jax_params``); and a
    JAX-format checkpoint's ``batch_stats`` through ``model_state_dict``."""
    from cpc_audio_tpu_torch import checkpoint as ckpt
    cfg = CPCConfig(hiddenEncoder=16, hiddenGar=16, sizeWindow=3200,
                    encoder_type=encoder, normMode=norm, speakerEmbedding=4,
                    rnnMode="ffd", nPredicts=2)
    gen = torch.Generator().manual_seed(8)
    model = build_model(cfg, gen)
    crit = build_criterion(cfg, gen, n_speakers=3)
    with torch.no_grad():       # statistics away from their initial 0 / 1
        for name, buf in model.named_buffers():
            if name.endswith((".mean", ".var")):
                buf.copy_(torch.rand(buf.shape, generator=gen) + 0.5)
    state = model.state_dict()

    ref = convert.export_cpc_model(model, cfg)
    back = convert.convert_cpc_model(ref, cfg)
    assert sorted(back) == sorted(state)
    for k, v in back.items():
        torch.testing.assert_close(v, state[k], rtol=0, atol=0)
    jparams, jstats = jconvert.convert_cpc_model(
        {k: v.numpy() for k, v in ref.items()}, cfg)
    from_jax = {**convert._strip(convert.params_from_jax(
        {"model": jparams}), "model."), **convert._stats_from_jax(jstats)}
    assert sorted(from_jax) == sorted(state)
    for k, v in from_jax.items():
        torch.testing.assert_close(v, state[k], rtol=0, atol=0)

    tree = convert.jax_tree(state)
    stats = convert.jax_batch_stats(state)
    assert bool(stats) == (norm == "batchNorm" and encoder == "cpc")
    model2 = build_model(cfg, torch.Generator().manual_seed(9))
    crit2 = build_criterion(cfg, torch.Generator().manual_seed(9),
                            n_speakers=3)
    convert.load_jax_params(model2, crit2, {
        "model": tree, "criterion": convert.jax_tree(crit.state_dict())},
        {"model": stats})
    for k, v in model2.state_dict().items():
        torch.testing.assert_close(v, state[k], rtol=0, atol=0)
    emb = crit.state_dict()["speakerEmb.embedding"]
    torch.testing.assert_close(crit2.state_dict()["speakerEmb.embedding"],
                               emb, rtol=0, atol=0)
    got = convert.convert_criterion(
        {"speakerEmb.weight": emb, **{
            f"wPrediction.{k}": v for k, v in _ffd_reference(crit).items()}},
        cfg)
    torch.testing.assert_close(got["speakerEmb.embedding"], emb)
    data = {"format": ckpt.JAX_FORMAT, "gEncoder": tree,
            "batch_stats": {"model": stats}}
    loaded = convert.model_state_dict(data, cfg)
    for k, v in loaded.items():
        torch.testing.assert_close(v, state[k], rtol=0, atol=0)


def _ffd_reference(crit) -> dict:
    """The reference's ``predictors.{k}.lin{n}.module.*`` of the port's ffd
    heads."""
    sd = crit.wPrediction.heads.state_dict()
    out = {}
    for k in range(sd["lin1.kernel"].shape[0]):
        for lin in ("lin1", "lin2"):
            out[f"predictors.{k}.{lin}.module.weight"] = \
                sd[f"{lin}.kernel"][k].T
            out[f"predictors.{k}.{lin}.module.bias"] = sd[f"{lin}.bias"][k]
    return out


def test_detached_loss_still_raises_outside_cpc_mode_none():
    """Only --cpc_mode none steps without a backward: under the InfoNCE
    criterion a loss that lost its graph raises in backward() rather than
    becoming a step of zero gradients."""
    cfg = CPCConfig(hiddenEncoder=C, hiddenGar=C, nPredicts=2,
                    negativeSamplingExt=4, sizeWindow=2560, arMode="GRU",
                    rnnMode="linear")
    model = build_model(cfg)
    crit = build_criterion(cfg)
    assert not isinstance(crit, NoneCriterion)

    class Detached(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.inner = crit

        def forward(self, *args, **kwargs):
            losses, acc = self.inner(*args, **kwargs)
            return losses.detach(), acc

    state = create_train_state(model, Detached(), "cpu", LR, cfg.beta1,
                               cfg.beta2, cfg.epsilon)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    with pytest.raises(RuntimeError, match="does not require grad"):
        make_train_step(state, "cpu")(_waves(2, cfg.sizeWindow, 5))
    assert state.step == 0
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), before[n]), n
