"""The port's ZeroSpeech feature dump and resampler
(cpc_audio_tpu_torch.eval.build_zerospeech_features, adjust_sample_rate)
against the JAX package's on the CPU: fea, npy and npz files from the same
checkpoint, lane-packed and --strict (with --seqNorm), phone posteriors
with --addCriterion, and byte-identical resampled audio."""

import glob
import os
import sys
import wave

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from cpc_audio_tpu import checkpoint as jckpt
from cpc_audio_tpu.config import CPCConfig as JCPCConfig
from cpc_audio_tpu.config import TrainConfig as JTrainConfig
from cpc_audio_tpu.criterion import supervised as jsup
from cpc_audio_tpu.eval import adjust_sample_rate as jresample
from cpc_audio_tpu.eval import build_zerospeech_features as jzs
from cpc_audio_tpu.models import build_model as jbuild_model
from cpc_audio_tpu_torch.eval import adjust_sample_rate as tresample
from cpc_audio_tpu_torch.eval import build_zerospeech_features as tzs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(hiddenEncoder=32, hiddenGar=32, sizeWindow=3200)
# float32 on the CPU in both packages, through 20 LSTM steps a chunk: sums
# in another order
ATOL = 1e-5
# --seqNorm divides each channel by its std over a chunk's 20 frames,
# which scales those differences by up to 1 / std and with |y|
SEQ_NORM_RTOL = 1e-4


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    root = tmp_path_factory.mktemp("zs")
    db = str(root / "db")
    sys.path.insert(0, os.path.join(REPO, "perf"))
    from soak_loader import make_tree
    make_tree(db, 4, 2, min_s=0.6, max_s=0.9, tone=True, quiet=True)
    cfg = JCPCConfig(**SMALL)
    base = str(root / "base")
    os.makedirs(base)
    jmodel = jbuild_model(cfg)
    x = jnp.zeros((1, 1, cfg.sizeWindow))
    mparams = jmodel.init({"params": jax.random.PRNGKey(3)}, x)["params"]
    ckpt = os.path.join(base, "checkpoint_0.pt")
    jckpt.save_checkpoint(mparams, {}, {}, mparams, ckpt)
    jckpt.save_args_sidecar(base, cfg)
    # a phone probe over that model, for --addCriterion
    phones = str(root / "phones.txt")
    with open(phones, "w") as f:
        for i, wav in enumerate(sorted(glob.glob(os.path.join(db, "*",
                                                              "*.wav")))):
            name = os.path.splitext(os.path.basename(wav))[0]
            f.write(f"{name} " + " ".join(str((i + t) % 4)
                                          for t in range(20)) + "\n")
    probe = str(root / "probe")
    os.makedirs(probe)
    jcrit = jsup.PhoneCriterion(cfg.hiddenGar, 4)
    c, z, _, _ = jmodel.apply({"params": mparams}, x)
    cparams = jcrit.init(jax.random.PRNGKey(4), c, z,
                         jnp.zeros(c.shape[:2], jnp.int32))["params"]
    jckpt.save_checkpoint(mparams, cparams, {}, mparams,
                          os.path.join(probe, "checkpoint_0.pt"))
    jckpt.save_args_sidecar(probe, cfg, JTrainConfig(
        load=[ckpt], pathPhone=phones, supervised=True))
    return db, ckpt, os.path.join(probe, "checkpoint_0.pt"), root


def _read(path, fmt):
    if fmt == "npy":
        return {"features": np.load(path)}
    if fmt == "npz":
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    rows = np.loadtxt(path, ndmin=2)
    return {"time": rows[:, 0], "features": rows[:, 1:]}


@pytest.mark.parametrize("fmt,extra", [
    ("fea", []), ("npy", ["--strict", "--seqNorm"]), ("npz", ["--strict"]),
    ("npy", ["--batch_lanes", "1"]),
    ("npy", ["--addCriterion"]), ("npy", ["--addCriterion", "--oneHot"])])
def test_feature_files_match_jax(fixture, tmp_path, fmt, extra):
    """Both CLIs over the same checkpoint and WAVs (chunks of 3200 samples:
    3-5 a file) write the same files, within ATOL (with --seqNorm also
    SEQ_NORM_RTOL)."""
    db, ckpt, probe, _ = fixture
    if "--addCriterion" in extra:
        ckpt = probe
    files = {}
    for who, main, kw in (("jax", jzs.main, {}),
                          ("port", tzs.main, {"device": "cpu"})):
        out = str(tmp_path / who)
        assert main([db, out, ckpt, "--format", fmt, "--maxSizeSeq", "3200"]
                    + extra, **kw) == 0
        files[who] = sorted(glob.glob(os.path.join(out, f"*.{fmt}")))
        assert os.path.exists(out + ".json")
    assert [os.path.basename(p) for p in files["port"]] == \
        [os.path.basename(p) for p in files["jax"]]
    assert len(files["port"]) == 4
    for got_p, want_p in zip(files["port"], files["jax"]):
        got, want = _read(got_p, fmt), _read(want_p, fmt)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].shape == want[k].shape, k
            np.testing.assert_allclose(
                got[k], want[k], atol=ATOL,
                rtol=SEQ_NORM_RTOL if "--seqNorm" in extra else 0,
                err_msg=f"{got_p} {k}")


def test_dead_flags_warn_and_af_needs_arrayfire(fixture, tmp_path, capsys):
    db, ckpt, _, _ = fixture
    argv = [db, str(tmp_path / "o"), ckpt, "--maxSizeSeq", "3200",
            "--clusters", "c.pt", "--format", "af"]
    with pytest.raises(ImportError):
        tzs.main(argv, device="cpu")
    assert "--clusters is accepted for reference-CLI parity" in \
        capsys.readouterr().out


def _wav(path, rate, n, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / rate
    x = 0.4 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.randn(n)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((x * 32767).astype("<i2").tobytes())


def test_adjust_sample_rate_is_byte_identical(tmp_path):
    """A 44.1 kHz WAV (and a second not in the phone list) through both
    CLIs: the same 16 kHz WAV, byte for byte, and only the listed one."""
    db = tmp_path / "clips"
    db.mkdir()
    _wav(str(db / "a.wav"), 44100, 44100 + 123)
    _wav(str(db / "b.wav"), 44100, 30000, seed=1)
    lst = tmp_path / "phones.tsv"
    lst.write_text("a 1 2 3\n")
    outs = {}
    for who, mod in (("jax", jresample), ("port", tresample)):
        out = str(tmp_path / who)
        assert mod.main([str(db), str(lst), out, "--file_extension",
                         ".wav"]) == 0
        outs[who] = sorted(os.listdir(out))
    assert outs["port"] == outs["jax"] == ["a.wav"]
    with open(tmp_path / "port" / "a.wav", "rb") as f1, \
            open(tmp_path / "jax" / "a.wav", "rb") as f2:
        got, want = f1.read(), f2.read()
    assert got == want
    with wave.open(str(tmp_path / "port" / "a.wav")) as w:
        assert w.getframerate() == 16000
