"""The port's lane-packed ``build_features_batched`` against its per-file
``build_feature`` and against the JAX package's batched extractor, on the
CPU in float32: same chunking, per-file state reset, tail padding and
per-chunk seq_norm; only the packing of files into lanes differs."""

import os
import sys
import wave

import numpy as np
import pytest
import torch

import jax

from cpc_audio_tpu import feature_loader as jfl
from cpc_audio_tpu.config import CPCConfig as JCPCConfig
from cpc_audio_tpu.models import build_model as jbuild_model
from cpc_audio_tpu_torch.config import CPCConfig
from cpc_audio_tpu_torch.convert import load_jax_params
from cpc_audio_tpu_torch.feature_loader import (FeatureModule, build_feature,
                                                build_features_batched)
from cpc_audio_tpu_torch.models import build_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = 3200            # 20 frames: each file spans several chunks


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("db"))
    sys.path.insert(0, os.path.join(REPO, "perf"))
    from soak_loader import make_tree
    make_tree(root, 7, 3, min_s=0.3, max_s=1.1, tone=True, quiet=True)
    return sorted(os.path.join(dp, f) for dp, _, fs in os.walk(root)
                  for f in fs if f.endswith(".wav"))


def _module(ar_mode, get_encoded=False, keep_hidden=True, seed=11):
    cfg = CPCConfig(hiddenEncoder=32, hiddenGar=24, arMode=ar_mode,
                    sizeWindow=CHUNK)
    model = build_model(cfg, torch.Generator().manual_seed(seed)).eval()
    return FeatureModule(model, get_encoded=get_encoded,
                         keep_hidden=keep_hidden)


def _per_file(fm, paths, seq_norm=False):
    return [build_feature(fm, p, max_size_seq=CHUNK, seq_norm=seq_norm)
            for p in paths]


def _batched(fm, paths, n_lanes, seq_norm=False):
    out = [None] * len(paths)
    for i, f in build_features_batched(fm, paths, n_lanes=n_lanes,
                                       max_size_seq=CHUNK,
                                       seq_norm=seq_norm):
        assert out[i] is None, "file yielded twice"
        out[i] = f
    assert all(f is not None for f in out), "missing files"
    return out


def _assert_same(got, want, rtol=0.0):
    """float32 at atol 1e-5: the batched forward runs the files' chunks at
    B = lanes, the per-file one at B = 1, so sums may round apart."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-5)


@pytest.mark.parametrize("ar_mode", ["LSTM", "GRU", "no_ar"])
def test_batched_matches_per_file(paths, ar_mode):
    fm = _module(ar_mode)
    _assert_same(_batched(fm, paths, 3), _per_file(fm, paths))


def test_batched_more_lanes_than_files(paths):
    fm = _module("LSTM")
    _assert_same(_batched(fm, paths[:3], 8), _per_file(fm, paths[:3]))


def test_batched_encoded_and_seq_norm(paths):
    """The encodings agree at atol 1e-5 before seq_norm.  seq_norm divides
    each channel of a chunk by its std over the chunk's frames, so after
    it an entry y may differ by (2 + |y|) * 1e-5 / std: the tolerance of
    each (chunk, channel), from the per-file encodings."""
    fm = _module("LSTM", get_encoded=True)
    raw = _per_file(fm, paths)
    _assert_same(_batched(fm, paths, 4), raw)
    got = _batched(fm, paths, 4, seq_norm=True)
    want = _per_file(fm, paths, seq_norm=True)
    step = CHUNK // 160
    for g, w, r in zip(got, want, raw):
        assert g.shape == w.shape
        for t in range(0, r.shape[1], step):
            std = r[:, t:t + step].std(axis=1, ddof=1) \
                if r[:, t:t + step].shape[1] > 1 else np.ones((1, r.shape[2]))
            tol = (2 + np.abs(w[:, t:t + step])) * 1e-5 / \
                np.maximum(std, 1e-4)[:, None, :] + 1e-6
            assert (np.abs(g[:, t:t + step] - w[:, t:t + step])
                    <= tol).all(), t


def test_batched_without_keep_hidden(paths):
    """Without keep_hidden every chunk starts from a zero state, in both
    paths; with it the later chunks differ."""
    fm = _module("LSTM", keep_hidden=False)
    got = _batched(fm, paths, 3)
    _assert_same(got, _per_file(fm, paths))
    carried = _batched(_module("LSTM"), paths, 3)
    longest = max(range(len(paths)), key=lambda i: got[i].shape[1])
    assert not np.allclose(got[longest], carried[longest], atol=1e-4)


def test_batched_lane_neighbours_are_isolated(paths):
    """A file's features do not depend on what its lane neighbours hold,
    nor on what its lane held before it."""
    fm = _module("LSTM")
    alone = _batched(fm, paths[:1], 1)[0]
    for n_lanes, order in ((2, [3, 0, 5]), (4, [1, 2, 4, 6, 0])):
        got = _batched(fm, [paths[i] for i in order], n_lanes)
        np.testing.assert_allclose(got[order.index(0)], alone, atol=1e-5)


def _write_wav(path, samples):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(samples, -1, 1) * 32767).astype("<i2")
                      .tobytes())


def test_seq_norm_one_frame_chunk_is_finite(tmp_path):
    """A file whose last chunk holds one frame: seq_norm gives zeros there,
    in both paths, never NaN."""
    path = tmp_path / "short.wav"
    rng = np.random.RandomState(2)
    _write_wav(path, 0.2 * rng.randn(CHUNK + 200))      # 20 + 1 frames
    fm = _module("LSTM")
    got = _batched(fm, [str(path)], 2, seq_norm=True)[0]
    want = _per_file(fm, [str(path)], seq_norm=True)[0]
    assert got.shape == (1, 21, 24) and np.isfinite(got).all()
    np.testing.assert_array_equal(got[0, -1], np.zeros(24, np.float32))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_batched_matches_jax_batched(paths):
    """The same weights through both packages' batched extractors."""
    cfg = JCPCConfig(hiddenEncoder=32, hiddenGar=24, sizeWindow=CHUNK)
    jmodel = jbuild_model(cfg)
    jvars = jmodel.init({"params": jax.random.PRNGKey(7)},
                        np.zeros((1, 1, CHUNK), np.float32))
    jfm = jfl.FeatureModule(jmodel, jvars, keep_hidden=True)
    want = [None] * len(paths)
    for i, f in jfl.build_features_batched(jfm, paths, n_lanes=3,
                                           max_size_seq=CHUNK):
        want[i] = np.asarray(f)
    model = build_model(CPCConfig(**cfg.to_dict()))
    load_jax_params(model, torch.nn.Module(), {"model": jvars["params"]})
    fm = FeatureModule(model.eval(), keep_hidden=True)
    _assert_same(_batched(fm, paths, 3), want)
