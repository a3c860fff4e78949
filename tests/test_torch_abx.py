"""The port's ABX (cpc_audio_tpu_torch.eval.abx, abx_cli, ops/dtw.py)
against the JAX package's on the CPU: scores on the same features and item
file, the on-device path against the host DTW, the plain-PyTorch DTW
against the native kernel, the streaming loader against the sequential
one, and the from_pre_computed CLI."""

import json
import os
import random

import numpy as np
import pytest
import torch

from cpc_audio_tpu.eval import abx_cli as jabx_cli
from cpc_audio_tpu_torch.eval import abx_cli
from cpc_audio_tpu_torch.eval.abx import group_computation as abx_g
from cpc_audio_tpu_torch.eval.abx import iterators as abx_it
from cpc_audio_tpu_torch.ops import dtw, native

N_FILES, FRAMES, DIM = 8, 60, 12
PHONES, CONTEXTS, SPEAKERS = ("a", "b", "c"), ("x", "y"), ("s0", "s1", "s2")


def _item_file(path, seed=0):
    """Segments of 3-7 frames (10 ms) over every file, with phones, contexts
    and each file's speaker drawn so that within- and across-speaker
    groups exist."""
    rng = random.Random(seed)
    lines = ["#file onset offset #phone prev-phone next-phone speaker"]
    for f in range(N_FILES):
        t = 0.0
        while t + 0.08 < FRAMES / 100:
            d = rng.randint(3, 7) / 100
            lines.append(f"f{f} {t:.2f} {t + d:.2f} {rng.choice(PHONES)} "
                         f"{rng.choice(CONTEXTS)} {rng.choice(CONTEXTS)} "
                         f"{SPEAKERS[f % len(SPEAKERS)]}")
            t += d
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def _features(seed=1):
    rng = np.random.RandomState(seed)
    return {f"f{f}": rng.randn(FRAMES, DIM).astype(np.float32)
            for f in range(N_FILES)}


@pytest.fixture()
def setup(tmp_path):
    item = str(tmp_path / "test.item")
    _item_file(item)
    feats = _features()
    seq_list = [(name, name) for name in sorted(feats)]
    return item, feats, seq_list


def _scores(module, item, feats, seq_list, **kw):
    return module.abx(lambda name: feats[name], item, seq_list, "cosine",
                      100.0, ["within", "across"], max_size_group=10, **kw)


def test_abx_matches_jax_on_the_same_features(setup):
    """Host DTW, within and across: the port's scores are the JAX
    package's, bit for bit (the same numpy host code, the same native
    DTW)."""
    item, feats, seq_list = setup
    want = _scores(jabx_cli, item, feats, seq_list)
    got = _scores(abx_cli, item, feats, seq_list)
    assert set(got) == {"within", "across"} == set(want)
    assert got == want
    assert all(0.0 <= v <= 1.0 for v in got.values())


def test_on_device_matches_host_dtw(setup):
    """--on_device (the buckets on a torch device, here the CPU) within
    1e-5 of the host DTW."""
    item, feats, seq_list = setup
    host = _scores(abx_cli, item, feats, seq_list)
    dev = _scores(abx_cli, item, feats, seq_list, on_device=True,
                  device="cpu")
    for mode in ("within", "across"):
        assert abs(dev[mode] - host[mode]) <= 1e-5, (mode, dev, host)


@pytest.mark.parametrize("symmetric", [False, True])
def test_dtw_device_matches_native(symmetric):
    """dtw_pairwise_device against native.dtw_batch on random ragged
    pairs (cosine-like distances in [0, 1]), within 1e-6."""
    rng = np.random.RandomState(3)
    N1, S = 5, 17
    N2 = N1 if symmetric else 4
    dist = rng.rand(N1, N2, S, S).astype(np.float32)
    sx = rng.randint(1, S + 1, size=N1)
    sy = sx if symmetric else rng.randint(1, S + 1, size=N2)
    if symmetric:               # a symmetric group: d(i, j) = d(j, i)^T
        dist = (dist + dist.transpose(1, 0, 3, 2)) / 2
    want = native.dtw_batch(dist, sx, sy, symmetric)
    got = dtw.dtw_pairwise_device(torch.from_numpy(dist), sx, sy, symmetric)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    flat = dtw.dtw_batch_device(torch.from_numpy(dist.reshape(-1, S, S)),
                                torch.from_numpy(np.repeat(sx, N2)),
                                torch.from_numpy(np.tile(sy, N1)))
    full = native.dtw_batch(dist, sx, sy, False)
    np.testing.assert_allclose(flat.numpy().reshape(N1, N2), full,
                               atol=1e-6)


def test_from_features_iter_is_bit_identical(setup):
    """Features streamed in another order give the sequential loader's
    segment layout and data, bit for bit."""
    item, feats, seq_list = setup
    seq = abx_it.ABXFeatureLoader(item, seq_list, lambda n: feats[n], 100.0,
                                  True)
    order = [n for n, _ in seq_list]
    stream = ((n, feats[n][None]) for n in reversed(order))
    got = abx_it.ABXFeatureLoader.from_features_iter(item, order, stream,
                                                     100.0, True)
    assert got.features == seq.features
    assert np.array_equal(got.data, seq.data)
    assert len(got) > 0


def test_group_scores_on_device_match_jax_buckets(setup):
    """The device path's buckets and chunking against the JAX package's
    own on-device scorer (on its CPU backend), group by group, within
    1e-5."""
    from cpc_audio_tpu.eval.abx import group_computation as jabx_g
    from cpc_audio_tpu.eval.abx import iterators as jabx_it
    item, feats, seq_list = setup
    for mod_it, mod_g, kw in ((jabx_it, jabx_g, {}),
                              (abx_it, abx_g, {"device": "cpu"})):
        data = mod_it.ABXFeatureLoader(item, seq_list, lambda n: feats[n],
                                       100.0, True)
        it = mod_it.ABXAcrossGroupIterator(data, 10)
        out = mod_g.get_abx_scores_dtw_on_group(
            it, mod_g.get_cosine_distance_batch, it.symmetric,
            on_device=True, **kw)
        if mod_g is jabx_g:
            want = out
    assert out[0] == want[0] and out[2] == want[2]
    np.testing.assert_allclose(out[1], want[1], atol=1e-5)


def test_from_pre_computed_cli(tmp_path, setup):
    """python -m ...abx_cli from_pre_computed ITEM FEATS: the port writes
    ABX_scores.json (the JAX CLI's scores) and ABX_args.json."""
    item, feats, _ = setup
    fdir = tmp_path / "feats"
    fdir.mkdir()
    for name, f in feats.items():
        np.save(str(fdir / f"{name}.npy"), f)
    outs = {}
    for who, mod in (("jax", jabx_cli), ("port", abx_cli)):
        out = str(tmp_path / who)
        assert mod.main(["from_pre_computed", item, str(fdir), "--out",
                         out]) == 0
        with open(os.path.join(out, "ABX_scores.json")) as f:
            outs[who] = json.load(f)
        assert os.path.exists(os.path.join(out, "ABX_args.json"))
    assert outs["port"] == outs["jax"]
    assert set(outs["port"]) == {"within", "across"}
