"""The port's learning gate (cpc_audio_tpu_torch/eval/learning_gate.py) on
the CPU: its plumbing at one CPC epoch and one probe epoch on a small
phone-labelled tree, the JSON line's fields and the exit code under
``--margin``.  The tree holds the gate's two probe files by name
(``PROBE_TRAIN``, ``PROBE_VAL``) with frame-level phone labels, under the
gate's default ``.flac`` extension: 16-bit PCM, which both the native
decoder and the wave module read by content."""

import json
import os
import wave

import numpy as np
import pytest

from cpc_audio_tpu.eval import learning_gate as jgate
from cpc_audio_tpu_torch.eval import learning_gate

SR, N_PHONES = 16000, 4


def _tree(root: str) -> str:
    """Two speakers, the gate's two probe files and two more; each file
    runs of 3-8 frames of a phone, a phone a tone.  Returns the labels'
    path."""
    rng = np.random.RandomState(0)
    stems = learning_gate.PROBE_TRAIN + learning_gate.PROBE_VAL + ["a", "b"]
    lines = []
    for i, stem in enumerate(stems):
        d = os.path.join(root, f"spk{i % 2}")
        os.makedirs(d, exist_ok=True)
        frames = 160
        runs = rng.randint(3, 9, size=frames)
        lab = np.repeat(rng.randint(N_PHONES, size=frames), runs)[:frames]
        t = np.arange(160) / SR
        x = np.concatenate([0.3 * np.sin(2 * np.pi * (200 + 150 * p) * t)
                            for p in lab]) + 0.02 * rng.randn(160 * frames)
        with wave.open(os.path.join(d, stem + ".flac"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(SR)
            w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2")
                          .tobytes())
        lines.append(stem + " " + " ".join(map(str, lab)))
    path = os.path.join(root, "phones.txt")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def test_gate_keeps_the_jax_flags():
    """The same flags and defaults as the JAX gate."""
    assert vars(learning_gate.parse_args([])) == vars(jgate.parse_args([]))
    assert learning_gate.PROBE_TRAIN == jgate.PROBE_TRAIN
    assert learning_gate.PROBE_VAL == jgate.PROBE_VAL


@pytest.mark.parametrize("margin,rc", [(-1.0, 0), (1.0, 1)])
def test_gate_runs_and_reports(tmp_path, capsys, margin, rc):
    """One CPC epoch and one probe epoch of each arm at a small width: the
    JSON line's fields, and exit 0 iff trained - random >= --margin."""
    db = str(tmp_path / "db")
    phones = _tree(db)
    got = learning_gate.main(
        ["--pathDB", db, "--pathPhone", phones, "--workdir",
         str(tmp_path / "work"), "--nEpochCPC", "1", "--nEpochProbe", "1",
         "--hiddenEncoder", "16", "--hiddenGar", "16", "--nPredicts", "2",
         "--negativeSamplingExt", "4", "--batchSizeGPU", "2",
         "--margin", str(margin)], device="cpu")
    line = [x for x in capsys.readouterr().out.splitlines()
            if x.startswith('{"gate"')][-1]
    result = json.loads(line)
    assert got == rc
    assert result["ok"] == (rc == 0)
    assert sorted(result) == sorted(
        ["gate", "ok", "acc_trained", "acc_random", "delta", "margin",
         "nEpochCPC", "negativeSamplingMode", "workdir"])
    assert 0.0 <= result["acc_trained"] <= 1.0
    assert 0.0 <= result["acc_random"] <= 1.0
    assert result["delta"] == pytest.approx(
        result["acc_trained"] - result["acc_random"], abs=2e-5)
    assert result["margin"] == margin and result["nEpochCPC"] == 1
