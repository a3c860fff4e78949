"""The port's shape gates and the shape adapters behind them, on the CPU,
against the JAX package's own gates and paths:

* each kernel module's ``supported`` over the configs users run (the
  default, ``--hiddenEncoder 384``, ``512`` and ``768`` with ``--hiddenGar``
  the same, ``--hiddenGar 100`` with LSTM and GRU, ``--sizeWindow
  40960``, and ``--sizeWindow 40960 --hiddenEncoder 512``, where JAX's K2
  gate refuses and its jnp attention runs): the port takes every shape
  that JAX's Pallas gates take, and ``build_model`` / ``build_criterion``
  build them;
* K3's gate over every model width the JAX package trains (D a multiple
  of 8, past 1024 too) in both dtypes, the builders taking D 200, 264,
  1056 and 2048, and K1's backward body at H 512 and 768 (a 16-CTA
  cluster in both dtypes);
* ``build_model`` / ``build_criterion`` refusing a config the port cannot
  take before any weight exists, with the flag named, and building the
  fused-layer switches at --hiddenEncoder 512 where JAX's own gates fall
  back too;
* the K1/K4 pad-and-slice adapter at H = 100 (ops/lstm.py, ops/gru.py)
  around the plain scans, against the unpadded plain scan and the JAX
  package's ``lax.scan`` layer, forward and ``jax.vjp``;
* the plain K3 at D = 384, 512 and 768 and the plain K5 at dk = 64, S =
  100 against the Pallas kernels in interpret mode.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cpc_audio_tpu.models.ar import _RecurrentLayer as JaxRecurrentLayer
from cpc_audio_tpu.ops.pallas.attention import (_padded_len,
                                                fused_attention_supported,
                                                fused_causal_attention)
from cpc_audio_tpu.ops.pallas.ffn import (fused_layer_tail,
                                          fused_tail_supported)
from cpc_audio_tpu.ops.pallas.conv_ln import \
    fused_conv_supported as jax_fused_conv_supported
from cpc_audio_tpu.ops.pallas.head_attention import \
    attention_block_supported as jax_attention_block_supported
from cpc_audio_tpu.ops.pallas.head_attention import \
    relpos_attention_supported
from cpc_audio_tpu.ops.pallas.rnn import pallas_rnn_supported
from cpc_audio_tpu_torch.config import CPCConfig
from cpc_audio_tpu_torch.criterion import build_criterion
from cpc_audio_tpu_torch.models import build_model
from cpc_audio_tpu_torch.models.ar import _RecurrentLayer
from cpc_audio_tpu_torch.ops import (attention_block, causal_attention, ffn,
                                     gru, head_attention, lstm)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.fixture
def no_fused_switches(monkeypatch):
    for name in ("CPC_ATTN_BLOCK", "CPC_PALLAS_CONV"):
        monkeypatch.delenv(name, raising=False)


# ---- the gates over the configs users run -----------------------------------

CONFIGS = {
    "default": {},
    "384 LSTM": dict(hiddenEncoder=384, hiddenGar=384),
    "512 LSTM": dict(hiddenEncoder=512, hiddenGar=512),
    "768 LSTM": dict(hiddenEncoder=768, hiddenGar=768),
    "512 transformer": dict(hiddenEncoder=512, hiddenGar=512,
                            arMode="transformer"),
    "hiddenGar 100 LSTM": dict(hiddenGar=100),
    "hiddenGar 100 GRU": dict(hiddenGar=100, arMode="GRU"),
    "sizeWindow 40960": dict(sizeWindow=40960),
    "sizeWindow 40960 transformer": dict(sizeWindow=40960,
                                         arMode="transformer"),
    "sizeWindow 40960 512": dict(sizeWindow=40960, hiddenEncoder=512,
                                 hiddenGar=512),
}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_gates_take_what_jax_takes(no_fused_switches, name, dtype):
    """At batch 32: where JAX's gate runs its Pallas kernel, the port's
    gate takes the shape; the recurrences take H = 100 (padded) where JAX
    falls back to lax.scan.  build_model builds every config and
    build_criterion all but --hiddenGar 100, whose transformer heads need
    hiddenGar == hiddenEncoder (in the JAX package too)."""
    cfg = CPCConfig(compute_dtype=dtype, **CONFIGS[name])
    tdt = {"bfloat16": torch.bfloat16, "float32": torch.float32}[dtype]
    B, D, H = 32, cfg.hiddenEncoder, cfg.hiddenGar
    S_ar = cfg.sizeWindow // 160
    S = S_ar - cfg.nPredicts
    jax_takes, port_takes = {}, {}
    if cfg.arMode in ("LSTM", "GRU"):
        mod, G = (lstm, 4) if cfg.arMode == "LSTM" else (gru, 3)
        jax_takes["rnn"] = pallas_rnn_supported(S_ar, B, G * H, H)
        port_takes["rnn"] = mod.supported(H) is None
    if cfg.arMode == "transformer":
        jax_takes["K5"] = fused_attention_supported(S_ar, D // 8, B * 8)
        port_takes["K5"] = causal_attention.supported(S_ar, D // 8,
                                                      tdt) is None
    jax_takes["K3"] = fused_tail_supported(B * S, D, 2048)
    port_takes["K3"] = ffn.supported(D, 2048, tdt) is None
    jax_takes["K2"] = relpos_attention_supported(_padded_len(S), D // 8, 8,
                                                 B)
    port_takes["K2"] = head_attention.supported(S, D // 8) is None
    # the port takes every one of these shapes, where JAX's Pallas gate
    # does and where it falls back to jnp or lax.scan
    assert all(port_takes.values()), (port_takes, jax_takes)
    model = build_model(cfg)
    if H != D and cfg.arMode not in ("transformer", "no_ar"):
        with pytest.raises(ValueError, match="--hiddenGar"):
            build_criterion(model.config)
    else:
        build_criterion(model.config)


def _tail_gate_takes_every_width(dtype):
    """K3's gate in ``dtype`` at F 2048 over every model width D a
    multiple of 8 in [8, 2048]: each is taken (past 1024 by the wide
    body), and the backward's shared memory (``_bwd_smem``) fits a block;
    between the multiples of 8 it refuses."""
    from cpc_audio_tpu_torch.ops import _build
    widths = range(8, 2049, 8)
    for D in widths:
        assert ffn._bwd_smem(D, 2048, dtype) <= _build.SMEM_LIMIT, D
    assert [D for D in widths if ffn.supported(D, 2048, dtype) is None] \
        == list(widths)
    for D in (4, 204, 1052):
        assert "multiple of 8" in ffn.supported(D, 2048, dtype), D


def test_tail_gate_in_bf16_takes_every_width_the_forward_takes():
    """bf16: every D a multiple of 8 up to 2048 at F 2048 (JAX's own
    Pallas gate takes D 128 and 256 at the train rows, and its jnp tail
    runs the rest), and the (D, F) pairs of the card tests; F must be a
    multiple of 64."""
    bf = torch.bfloat16
    _tail_gate_takes_every_width(bf)
    for D, F in ((64, 128), (32, 64), (256, 256), (512, 2048),
                 (256, 2048), (384, 2048), (1024, 2048), (40, 128),
                 (200, 2048), (1056, 2048), (2048, 128)):
        assert ffn.supported(D, F, bf) is None, (D, F)
    assert "multiple of 64" in ffn.supported(256, 96, bf)


def test_tail_gate_in_float32_takes_every_width():
    """float32: every D a multiple of 8 up to 2048 at F 2048, and F any
    multiple of 32 (a warp's 32 hidden columns make one word of live
    bits)."""
    f32 = torch.float32
    _tail_gate_takes_every_width(f32)
    for D, F in ((96, 96), (384, 160), (1024, 32), (40, 64), (1056, 96)):
        assert ffn.supported(D, F, f32) is None, (D, F)
    assert "multiple of 32" in ffn.supported(256, 48, f32)


def test_lstm_bwd_body_at_512_is_a_16_cta_cluster_in_bf16():
    """K1's backward at H 512: the cluster body on 16 CTAs in bf16, whose
    CTA (W_hh's 128 gate rows by 512 + 8 bf16, receive buffers, ring)
    fits 227 KB; in float32 W_hh's slice (128 x 512 float32) does not fit
    as it is, so the 16-CTA body holds its two bf16 planes partly in
    registers and shared memory and streams the rest, as at H 768 in
    both dtypes.  H 128 and 256 keep 8 CTAs, and K4 keeps its bodies."""
    from cpc_audio_tpu_torch.ops import _build
    bf, f32 = torch.bfloat16, torch.float32
    assert lstm.CLUSTER == {128: 8, 256: 8, 512: 16, 768: 16}
    assert gru.CLUSTER == {128: 8, 256: 8}
    assert lstm.bwd_body(512, bf) == "cluster"
    assert lstm.bwd_body(512, f32) == "cluster"
    assert 512 in lstm.BWD_STREAM_F32 and 512 not in lstm.BWD_STREAM
    assert lstm.cluster_smem(512, 4, bf, 5 * 8 + 2 * 2, 16) \
        <= _build.SMEM_LIMIT
    assert lstm.cluster_smem(512, 4, bf, 5 * 8 + 2 * 2, 8) \
        > _build.SMEM_LIMIT
    assert lstm.cluster_smem(512, 4, f32, 5 * 8 + 2 * 4, 16) \
        > _build.SMEM_LIMIT
    for H in (128, 256):
        for dt in (bf, f32):
            assert lstm.bwd_body(H, dt) == gru.bwd_body(H, dt) == "cluster"
    assert lstm.bwd_body(104, bf) == "rows"
    for H in (384, 1024, 2048):
        assert lstm.bwd_body(H, bf) == "grid", H
    assert lstm.bwd_body(768, bf) == "cluster"
    assert lstm.bwd_body(768, f32) == "cluster"
    assert gru.bwd_body(512, bf) == gru.bwd_body(512, f32) == "grid"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_grid_bodies_take_every_width_past_256_without_a_cluster_body(dtype):
    """The grid bodies (csrc/rnn_grid.cuh) at K1's H 264, 1056, 2048 and
    4096 and K4's 512, 768 and 4096 in both directions; K1 runs its
    cluster forward (8 CTAs at H 128, 16 at 256) and 8-CTA backward at H
    128 and 256, its rows forward and backward at 200 and its 16-CTA
    bodies at 512 and 768; K4 its cluster forward and backward at 256."""
    for H in (264, 1056, 2048, 4096):
        assert lstm.fwd_body(H, dtype) == lstm.bwd_body(H, dtype) == "grid"
    for H in (512, 768, 4096):
        assert gru.fwd_body(H, dtype) == gru.bwd_body(H, dtype) == "grid"
    assert [lstm.fwd_body(H, dtype) for H in (128, 200, 256)] == [
        "cluster", "rows", "cluster"]
    assert [lstm.bwd_body(H, dtype) for H in (128, 200, 256)] == [
        "cluster", "rows", "cluster"]
    for H in (512, 768):
        assert lstm.fwd_body(H, dtype) == lstm.bwd_body(H, dtype) \
            == "cluster"
    assert gru.fwd_body(256, dtype) == "cluster"
    assert gru.bwd_body(256, dtype) == "cluster"


@pytest.mark.parametrize("sms", [132, 114])
def test_grid_split_shared_memory_and_scratch_follow_their_formula(sms):
    """The Python mirror of the grid bodies' split (``lstm.grid_shape``),
    shared memory (``grid_smem``) and scratch (``grid_scratch``) against
    the formula written out (csrc/rnn_grid.cuh): at K1's H 1056 on 132 SMs
    J 8 units on all 132 CTAs, W_hh's slice in shared memory (66 chunks
    of 2 m-tiles by 16 columns, 1 KB a plane) beside 16 k-parts of 32 rows
    by 36 float32, the backward's partial carries as 66 x 4 (16-column,
    8-row) tiles of 512 bytes a CTA; at H 4096 J 32 on 128 CTAs, the slice
    streamed through 128 KB of stages; every H the gates take, to 8192,
    fits the card's SMs in both dtypes and both directions of both
    recurrences (on 114, an H100 PCIe's, H 4096 takes J 36 on 114 CTAs,
    24 rows a launch, and H 8192 J 72 on 114, 8 rows a launch; on 132 H
    8192 takes J 64 on 128 CTAs, 16 rows); the float32 backward past J 44
    (K1) streams each chunk in two pieces of half its m-tiles, whose 16
    rings of one stage fit where whole chunks' would not."""
    from cpc_audio_tpu_torch.ops import _build
    f32, bf = torch.float32, torch.bfloat16
    assert lstm.MAX_H == 8192 and gru.MAX_H == lstm.MAX_H
    for H in range(264, lstm.MAX_H + 1, 8):
        s = lstm.grid_shape(H, 4, sms)
        assert s["ok"] and s["J"] % 2 == 0 and s["ncta"] <= sms, H
        assert s["J"] <= lstm.GRID_MAX_J and s["rows"] >= 8, H
        assert (s["ncta"] - 1) * s["J"] < H <= s["ncta"] * s["J"], H
        for G in (4, 3):
            for dt in (f32, bf):
                for backward in (False, True):
                    assert 0 < lstm.grid_smem(H, G, dt, sms, backward) \
                        <= _build.SMEM_LIMIT, (H, G, dt, backward)
    s = lstm.grid_shape(8192, 4, sms)
    assert (s["J"], s["ncta"], s["rows"]) == (
        (64, 128, 16) if sms == 132 else (72, 114, 8))
    extra = 2 * 32 * (16 * s["MT"] + 8) * 2 + 512 * 8 + 2048 * 4
    half = -(-s["MT"] // 2)
    # float32: 16 rings of one whole 2-plane chunk pass 227 KB, of half
    # of one fit
    assert 16 * 2 * s["MT"] * 512 + extra > _build.SMEM_LIMIT
    assert lstm.grid_pieces(s["MT"], 2) == 2
    assert lstm.grid_smem(8192, 4, f32, sms, True) \
        == 16 * 2 * half * 512 + extra
    # bf16: whole chunks, one stage a ring
    assert lstm.grid_pieces(s["MT"], 1) == 1
    assert lstm.grid_smem(8192, 4, bf, sms, True) \
        == 16 * s["MT"] * 512 + extra
    if sms != 132:
        s = lstm.grid_shape(4096, 4, sms)
        assert (s["J"], s["ncta"], s["rows"]) == (36, 114, 24)
        return
    s = lstm.grid_shape(1056, 4, sms)
    assert (s["J"], s["ncta"], s["KS"], s["MT"], s["KW"]) == (8, 132, 66, 2,
                                                             16)
    part = 16 * 32 * (2 * 16 + 4) * 4
    assert lstm.grid_smem(1056, 4, bf, sms, False) == 66 * 1024 + part
    assert lstm.grid_smem(1056, 4, f32, sms, False) == 66 * 2048 + part
    extra = 2 * 32 * (2 * 16 + 8) * 2 + 512 * 8 + 32 * 64 * 4
    assert lstm.grid_smem(1056, 4, f32, sms, True) == 66 * 2048 + extra
    # W_hh packed into the CTAs' chunks (here exactly its 4H x H, in two
    # planes in float32), then the exchange or the receive blocks
    assert lstm.grid_scratch(32, 1056, 4, bf, sms, False) \
        == 4 * 1056 ** 2 * 2 + 2 * 4 * 66 * 32 * 16
    assert lstm.grid_scratch(32, 1056, 4, f32, sms, True) \
        == 2 * 4 * 1056 ** 2 * 2 + 2 * 132 * 66 * 4 * 32 * 16
    s = lstm.grid_shape(4096, 4, sms)
    assert (s["J"], s["ncta"], s["MT"], s["MW"], s["KW"]) == (32, 128, 8, 4,
                                                             4)
    assert lstm.grid_smem(4096, 4, bf, sms, False) \
        == 128 * 1024 + 4 * 32 * (8 * 16 + 4) * 4
    assert lstm.grid_scratch(4, 4096, 4, bf, sms, True) \
        == 4 * 4096 ** 2 * 2 + 2 * 128 * 256 * 1 * 32 * 16
    s = lstm.grid_shape(4096, 3, sms)
    assert (s["MT"], s["MW"], s["KW"]) == (6, 3, 5)
    assert lstm.grid_scratch(100, 512, 3, bf, sms, False) \
        == lstm.grid_scratch(32, 512, 3, bf, sms, False)


# configurations the JAX package trains that the port once refused: K5
# at dk 256 (the AR's 8 heads of 2048) and S 1024, K2 at S 1012, K1 and K4
# at H 4096 (the model: the heads refuse hiddenGar != hiddenEncoder, in
# JAX too); and at the widened limits, the default heads' K2 at S 4084
# (--sizeWindow 655360, 41 s windows), K5 at S 4096 and at dk 512, K1 and
# K4 at H 8192
TAKEN = [
    ("model", dict(arMode="transformer", hiddenEncoder=2048,
                   hiddenGar=2048), "--hiddenEncoder 2048"),
    ("model", dict(arMode="transformer", sizeWindow=163840),
     "--sizeWindow 163840"),
    ("model", dict(hiddenGar=4096), "--hiddenGar 4096"),
    ("criterion", dict(sizeWindow=655360), "--sizeWindow 655360"),
    ("model", dict(arMode="transformer", sizeWindow=655360),
     "--arMode transformer --sizeWindow 655360"),
    ("model", dict(arMode="transformer", hiddenEncoder=4096,
                   hiddenGar=4096), "--hiddenEncoder 4096"),
    ("model", dict(hiddenGar=8192), "--hiddenGar 8192"),
]

# past each limit, the builder that refuses it and the flag it names (with
# the limit: the gates' messages give it)
REFUSED = [
    ("criterion", dict(hiddenGar=100), {}, "--hiddenGar 100"),
    ("criterion", dict(hiddenEncoder=204, hiddenGar=204), {},
     "--hiddenEncoder 204"),
    ("criterion", dict(hiddenEncoder=1052, hiddenGar=1052), {},
     "--hiddenEncoder 1052"),
    # the heads' S 4097
    ("criterion", dict(sizeWindow=657440), {},
     r"--sizeWindow 657440 .*S <= 4096"),
    # K5's S 4097
    ("model", dict(arMode="transformer", sizeWindow=655520), {},
     r"--sizeWindow 655520 .*\[1, 4096\]"),
    ("model", dict(hiddenGar=8200), {}, r"--hiddenGar 8200 .*\[1, 8192\]"),
    # K5's dk 513
    ("model", dict(arMode="transformer", hiddenEncoder=4104,
                   hiddenGar=4104), {}, r"--hiddenEncoder 4104 .*\[1, 512\]"),
    # the heads' K2 at dk 4097, past the cluster body's 8 CTAs
    ("criterion", dict(hiddenEncoder=32776, hiddenGar=32776), {},
     r"--hiddenEncoder 32776 .*dk <= 4096"),
]


# widths the JAX package trains that are no multiple of 32, or past 1024
WIDE_OR_ODD = (200, 264, 1056, 2048)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("D", WIDE_OR_ODD)
def test_builders_take_every_multiple_of_8(no_fused_switches, D, dtype):
    """--hiddenEncoder D with --hiddenGar D, a multiple of 8 that is no
    multiple of 32 or past 1024: every kernel's gate takes it (K3 masks
    the columns past D and crosses column tiles past 1024, K2 takes any
    dk, K8 walks rows past 4096 bytes in pieces), and build_model /
    build_criterion build it; at 1056 and 2048, whose weights would take
    most of a gigabyte on the CPU, the builders' own gate
    (``check_kernels``, which each runs first) takes it."""
    from cpc_audio_tpu_torch.criterion import infonce
    from cpc_audio_tpu_torch.models import cpc
    from cpc_audio_tpu_torch.ops import scatter_add
    cfg = CPCConfig(compute_dtype=dtype, hiddenEncoder=D, hiddenGar=D)
    tdt = {"bfloat16": torch.bfloat16, "float32": torch.float32}[dtype]
    S = cfg.sizeWindow // 160 - cfg.nPredicts
    assert ffn.supported(D, 2048, tdt) is None
    assert head_attention.supported(S, D // 8) is None
    assert scatter_add.supported(D, tdt) is None
    assert lstm.supported(D) is None
    cpc.check_kernels(cfg)
    infonce.check_kernels(cfg)
    if D <= 264:
        build_criterion(build_model(cfg).config)


@pytest.mark.parametrize("builder,kw,flag", TAKEN,
                         ids=[r[2] for r in TAKEN])
def test_builders_take_with_the_flag(no_fused_switches, builder, kw, flag):
    """A config the port once refused, naming its flag: every gate of the
    card's path takes it (K5 at dk 256 and 512 and at S 1024 and 4096 in
    both dtypes, K2 at S 1012 and 4084, K1 and K4 at H 4096 and 8192 for
    LSTM and GRU), so the builders' own gates (``check_kernels``) take
    it; at the default widths, where the weights are small, build_model
    and build_criterion build it.  At --hiddenGar 4096 and 8192 the
    criterion still refuses hiddenGar != hiddenEncoder, as the JAX
    package's heads do."""
    from cpc_audio_tpu_torch.criterion import infonce
    from cpc_audio_tpu_torch.models import cpc
    cfg = CPCConfig(**kw)             # float32, the CLIs' default
    S = cfg.sizeWindow // 160
    if cfg.arMode == "transformer":
        for dt in (torch.bfloat16, torch.float32):
            assert causal_attention.supported(
                S, cfg.hiddenEncoder // 8, dt) is None
        assert head_attention.supported(S - cfg.nPredicts,
                                        cfg.hiddenEncoder // 8) is None
        cpc.check_kernels(cfg)
        infonce.check_kernels(cfg.replace(hiddenGar=cfg.hiddenEncoder))
        if cfg.hiddenEncoder <= 256:
            build_criterion(build_model(cfg).config)
    else:
        for mode in ("LSTM", "GRU"):
            assert (lstm if mode == "LSTM" else gru).supported(
                cfg.hiddenGar) is None
            cpc.check_kernels(cfg.replace(arMode=mode))
        if cfg.hiddenGar != cfg.hiddenEncoder:
            with pytest.raises(ValueError,
                               match=f"--hiddenGar {cfg.hiddenGar}"):
                infonce.check_kernels(cfg)
        else:         # the default heads at a long window
            assert head_attention.supported(S - cfg.nPredicts,
                                            cfg.hiddenEncoder // 8) is None
            infonce.check_kernels(cfg)
            build_criterion(build_model(cfg).config)


@pytest.mark.parametrize("builder,kw,env,flag", REFUSED,
                         ids=[r[3] for r in REFUSED])
def test_builders_refuse_with_the_flag(monkeypatch, builder, kw, env, flag):
    """A config the port's kernels cannot take raises ValueError naming
    its flag, from build_model or build_criterion, before any weight or
    step exists; no plain version runs in its place."""
    for name in ("CPC_ATTN_BLOCK", "CPC_PALLAS_CONV"):
        monkeypatch.setenv(name, env.get(name, "0"))
    cfg = CPCConfig(**kw)
    build = build_model if builder == "model" else build_criterion
    with pytest.raises(ValueError, match=flag):
        build(cfg)


def test_fused_switches_at_512_follow_jax_gates(monkeypatch):
    """Under CPC_ATTN_BLOCK=1 and CPC_PALLAS_CONV=1 at --hiddenEncoder 512
    JAX's gates take neither the whole-block kernel nor the fused conv
    layers (its jnp / XLA paths run); the port's gates refuse them too, so
    the builders build, the heads run K2 and the encoder cuDNN, as
    without the switches."""
    monkeypatch.setenv("CPC_ATTN_BLOCK", "1")
    monkeypatch.setenv("CPC_PALLAS_CONV", "1")
    cfg = CPCConfig(hiddenEncoder=512, hiddenGar=512)
    T, S = cfg.sizeWindow // 5, cfg.sizeWindow // 160 - cfg.nPredicts
    assert not jax_attention_block_supported(_padded_len(S), 64, 8, 32, 12)
    assert not jax_fused_conv_supported(T, 512, 8, 4, 2)
    model = build_model(cfg)
    assert model.gEncoder.fused_layers(cfg.sizeWindow) == ()
    crit = build_criterion(model.config)
    assert not attention_block.attention_block_supported(S, 8, 64)
    assert crit.wPrediction.heads.layer0.multihead.attention_block


def test_transformer_heads_need_hidden_gar_equal_in_jax_too():
    """The port's build_criterion refuses --hiddenGar != --hiddenEncoder
    (the transformer prediction heads read hiddenGar-wide contexts into
    hiddenEncoder-wide layers); the JAX criterion cannot take it either."""
    from cpc_audio_tpu.criterion.infonce import \
        CPCUnsupervisedCriterion as JaxCriterion
    crit = JaxCriterion(n_predicts=2, dim_output_ar=100,
                        dim_output_encoder=64, negative_sampling_ext=4,
                        size_input_seq=16)
    keys = {n: jax.random.PRNGKey(i)
            for i, n in enumerate(("params", "sampling", "dropout"))}
    with pytest.raises(TypeError):
        crit.init(keys, jnp.zeros((2, 16, 100)), jnp.zeros((2, 16, 64)))
    with pytest.raises(ValueError, match="--hiddenGar 100"):
        build_criterion(CPCConfig(hiddenGar=100, hiddenEncoder=64))


# ---- K1 / K4 at any H: the pad-and-slice adapter -----------------------------

@pytest.mark.parametrize("mode", ["LSTM", "GRU"])
def test_recurrence_padded_to_the_kernels_width_at_h100(monkeypatch, mode):
    """H = 100 runs at H = 104 (LSTM) or 128 (GRU) with zero units and is
    sliced back: forward and gradients equal the unpadded plain scan, and
    the JAX package's lax.scan layer (CPC_PALLAS_RNN=0) with jax.vjp, on
    every input and weight."""
    monkeypatch.setenv("CPC_PALLAS_RNN", "0")
    B, T, C, H = 2, 6, 16, 100
    G = 4 if mode == "LSTM" else 3
    rng = np.random.RandomState(G)
    w_ih = rng.randn(G * H, C) * 0.2
    w_hh = rng.randn(G * H, H) * 0.1
    b_ih, b_hh = rng.randn(G * H) * 0.1, rng.randn(G * H) * 0.1
    x = rng.randn(B, T, C)
    h0s = [rng.randn(B, H) * 0.1 for _ in range(2 if mode == "LSTM" else 1)]
    dys, dhT = rng.randn(B, T, H), rng.randn(B, H)
    layer = _RecurrentLayer(C, H, mode, None)
    with torch.no_grad():
        for n, a in (("weight_ih", w_ih), ("weight_hh", w_hh),
                     ("bias_ih", b_ih), ("bias_hh", b_hh)):
            getattr(layer, n).copy_(_t(a))
    xt = _t(x).requires_grad_()
    ht = [_t(h).requires_grad_() for h in h0s]
    ys, hid = layer(xt, tuple(ht) if mode == "LSTM" else ht[0])
    hT = hid[0] if mode == "LSTM" else hid
    leaves = [xt, *ht, layer.weight_ih, layer.weight_hh, layer.bias_ih,
              layer.bias_hh]
    grads = torch.autograd.grad((ys * _t(dys)).sum() + (hT * _t(dhT)).sum(),
                                leaves)

    # the unpadded plain scan on the same projection
    xs = [t.detach().clone().requires_grad_() for t in leaves]
    xp = xs[0] @ xs[-4].t() + xs[-2]
    if mode == "LSTM":
        ys_r, hT_r, _ = lstm.lstm_scan_ref(xp + xs[-1], xs[-3], xs[1], xs[2])
    else:
        ys_r, hT_r = gru.gru_scan_ref(xp, xs[-3], xs[-1], xs[1])
    grads_r = torch.autograd.grad((ys_r * _t(dys)).sum()
                                  + (hT_r * _t(dhT)).sum(), xs)
    # f32 both sides; the padded product adds exact zeros, summed in
    # another blocking
    torch.testing.assert_close(ys, ys_r, atol=1e-5, rtol=1e-5)
    for g, w in zip(grads, grads_r):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)

    params = {"weight_ih_t": jnp.asarray(w_ih.T, jnp.float32),
              "weight_hh_t": jnp.asarray(w_hh.T, jnp.float32),
              "bias_ih": jnp.asarray(b_ih, jnp.float32),
              "bias_hh": jnp.asarray(b_hh, jnp.float32)}
    jlayer = JaxRecurrentLayer(H, mode)

    def run(p, x, *h0):
        ys, hid = jlayer.apply({"params": p}, x,
                               tuple(h0) if mode == "LSTM" else h0[0])
        return ys, (hid[0] if mode == "LSTM" else hid)

    (ys_j, hT_j), vjp = jax.vjp(run, params, jnp.asarray(x, jnp.float32),
                                *(jnp.asarray(h, jnp.float32) for h in h0s))
    gp, gx, *gh = vjp((jnp.asarray(dys, jnp.float32),
                       jnp.asarray(dhT, jnp.float32)))
    # f32 both sides; lax.scan's products in another order over 6 steps
    np.testing.assert_allclose(ys.detach().numpy(), np.asarray(ys_j),
                               atol=2e-5)
    np.testing.assert_allclose(hT.detach().numpy(), np.asarray(hT_j),
                               atol=2e-5)
    want = [gx, *gh, np.asarray(gp["weight_ih_t"]).T,
            np.asarray(gp["weight_hh_t"]).T, gp["bias_ih"], gp["bias_hh"]]
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-5)


# ---- K3 at D = 384-768 and K5 at dk = 64 against the Pallas kernels ---------

@pytest.mark.parametrize("D", [384, 512, 768])
def test_layer_tail_ref_at_512_matches_pallas_interpret(D):
    """The plain K3 at the --hiddenEncoder 384, 512 and 768 widths,
    forward and vjp, against fused_layer_tail in interpret mode (its
    kernel takes any D a multiple of 128; only its VMEM gate refuses D 384
    and up at the train rows), float32."""
    K, M, F = 1, 16, 2048
    rng = np.random.RandomState(D)
    args = [a.astype(np.float32) for a in (
        rng.randn(K, M, D) * 0.5, 1.0 + 0.1 * rng.randn(K, D),
        0.1 * rng.randn(K, D), rng.randn(K, D, F) / np.sqrt(D),
        0.1 * rng.randn(K, F), rng.randn(K, F, D) / np.sqrt(F),
        0.1 * rng.randn(K, D), 1.0 + 0.1 * rng.randn(K, D),
        0.1 * rng.randn(K, D))]
    dout = rng.randn(K, M, D).astype(np.float32)
    seed = jnp.zeros((1,), jnp.float32)
    out_j, vjp = jax.vjp(
        lambda *a: fused_layer_tail(*a, seed, 0.0, 1e-5, True),
        *map(jnp.asarray, args))
    grads_j = vjp(jnp.asarray(dout))
    out = ffn.layer_tail_ref(*map(_t, args))
    # f32 both sides; 512- and 2048-long sums in another order
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=5e-5,
                               rtol=1e-5)
    grads = ffn.layer_tail_bwd_ref(*map(_t, args), _t(dout))
    names = ("dx", "dln1w", "dln1b", "dw1", "db1", "dw2", "db2", "dln2w",
             "dln2b")
    for name, g, w in zip(names, grads, grads_j):
        w = np.asarray(w)
        np.testing.assert_allclose(
            g.numpy(), w, atol=1e-4 * max(np.abs(w).max(), 1.0),
            err_msg=name)


def test_causal_attention_ref_at_dk64_matches_pallas_interpret():
    """The plain K5 at the --hiddenGar 512 head width (dk 64) and a ragged
    S = 100 (padded to 128 inside the JAX kernel), forward and vjp at
    rate 0, against fused_causal_attention in interpret mode."""
    N, S, dk = 8, 100, 64
    rng = np.random.RandomState(64)
    q, k, v = (rng.randn(N, S, dk).astype(np.float32) for _ in range(3))
    bias = (rng.randn(N, S, S) * 0.5).astype(np.float32)
    dout = rng.randn(N, S, dk).astype(np.float32)
    seed = jnp.zeros((1,), jnp.float32)
    out_j, vjp = jax.vjp(
        lambda *a: fused_causal_attention(*a, seed, 0.0, True),
        *(jnp.asarray(a) for a in (q, k, v, bias)))
    grads_j = vjp(jnp.asarray(dout))
    out = causal_attention.causal_attention_ref(*map(_t, (q, k, v, bias)))
    # f32 both sides; softmax and 64-long sums in another order
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=2e-5)
    grads = causal_attention.causal_attention_bwd_ref(
        *map(_t, (q, k, v, bias)), _t(dout))
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), grads, grads_j):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-5,
                                   err_msg=name)
