"""The port (cpc_audio_tpu_torch) stands alone: it names nothing of the JAX
package in an import, its own copies of the JAX package's host modules
(config, utils, data, ops/native) match the originals, and its trainer
runs on the GPU unless the caller asks for the CPU."""

import argparse
import dataclasses
import glob
import os
import re

import numpy as np
import pytest
import torch

from cpc_audio_tpu import checkpoint as jckpt
from cpc_audio_tpu import config as jconfig
from cpc_audio_tpu.data import dataset as jdataset
from cpc_audio_tpu.utils import misc as jmisc
from cpc_audio_tpu_torch import checkpoint as tckpt
from cpc_audio_tpu_torch import config as tconfig
from cpc_audio_tpu_torch import train as ttrain
from cpc_audio_tpu_torch.data import audio_io, dataset as tdataset
from cpc_audio_tpu_torch.ops import native
from cpc_audio_tpu_torch.utils import misc as tmisc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_JAX_IMPORT = re.compile(r"^\s*(import\s+cpc_audio_tpu(\s|\.|,|$)|"
                         r"from\s+cpc_audio_tpu(\.\S*)?\s+import\s)")


def _port_sources():
    files = glob.glob(os.path.join(REPO, "cpc_audio_tpu_torch", "**", "*.py"),
                      recursive=True)
    return sorted(files) + [os.path.join(REPO, "chip_smoke.py")]


def test_port_sources_import_nothing_of_the_jax_package():
    assert len(_port_sources()) > 20
    bad = [f"{os.path.relpath(path, REPO)}:{n}: {line.strip()}"
           for path in _port_sources()
           for n, line in enumerate(open(path), 1)
           if _JAX_IMPORT.match(line)
           or re.match(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax)\b",
                       line)]
    assert not bad, bad


def test_source_scan_sees_a_jax_package_import():
    """The pattern of the scan above catches each form of import."""
    for line in ("import cpc_audio_tpu", "import cpc_audio_tpu.config",
                 "    from cpc_audio_tpu.config import CPCConfig",
                 "from cpc_audio_tpu import config"):
        assert _JAX_IMPORT.match(line), line
    for line in ("import cpc_audio_tpu_torch",
                 "from cpc_audio_tpu_torch.config import CPCConfig",
                 "# from cpc_audio_tpu.config import CPCConfig"):
        assert not _JAX_IMPORT.match(line), line


@pytest.mark.parametrize("cls", ["CPCConfig", "TrainConfig"])
def test_config_copy_has_the_jax_fields_and_defaults(cls):
    jf = [(f.name, f.default) for f in
          dataclasses.fields(getattr(jconfig, cls))]
    tf = [(f.name, f.default) for f in
          dataclasses.fields(getattr(tconfig, cls))]
    assert tf == jf


def test_cli_flags_match_the_jax_package():
    jns = jconfig.add_cpc_args(argparse.ArgumentParser()).parse_args([])
    tns = tconfig.add_cpc_args(argparse.ArgumentParser()).parse_args([])
    assert vars(tns) == vars(jns)
    assert tconfig.config_from_namespace(tns).to_dict() == \
        jconfig.config_from_namespace(jns).to_dict()
    assert tconfig.get_default_cpc_config().to_dict() == \
        jconfig.get_default_cpc_config().to_dict()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_args_sidecar_loads_in_the_other_package(tmp_path,
                                                            writer):
    """A checkpoint_args.json written by either package gives the same
    config in both."""
    cfg = dict(arMode="GRU", hiddenGar=64, nPredicts=4, abspos=True,
               compute_dtype="bfloat16")
    run = dict(pathDB="/data", batchSizeGPU=16, save_step=2)
    if writer == "jax":
        jckpt.save_args_sidecar(str(tmp_path), jconfig.CPCConfig(**cfg),
                                jconfig.TrainConfig(**run))
    else:
        tckpt.save_args_sidecar(str(tmp_path), tconfig.CPCConfig(**cfg),
                                tconfig.TrainConfig(**run))
    (tmp_path / "checkpoint_3.pt").write_bytes(b"")
    _, _, jcfg, jraw = jckpt.get_checkpoint_data(str(tmp_path))
    _, _, tcfg, traw = tckpt.get_checkpoint_data(str(tmp_path))
    assert traw == jraw
    assert tcfg.to_dict() == jcfg.to_dict()
    assert tcfg.arMode == "GRU" and tcfg.hiddenGar == 64
    assert tconfig.TrainConfig.from_dict(traw).to_dict() == \
        jconfig.TrainConfig.from_dict(jraw).to_dict()


def test_utils_copy_matches():
    for epoch in range(12):
        assert tmisc.lr_for_epoch(2e-4, epoch, 3, 4) == \
            jmisc.lr_for_epoch(2e-4, epoch, 3, 4)
    logs = {"a": np.array([2.0, 4.0])}
    np.testing.assert_array_equal(tmisc.update_logs(logs, 2)["a"],
                                  jmisc.update_logs(logs, 2)["a"])


def test_data_copy_finds_and_decodes_the_same(tmp_path):
    import sys
    sys.path.insert(0, os.path.join(REPO, "perf"))
    from soak_loader import make_tree
    make_tree(str(tmp_path), 4, 2, min_s=0.2, max_s=0.3, tone=True,
              quiet=True)
    seqs_t, spk_t = tdataset.find_all_seqs(str(tmp_path), extension=".wav",
                                           load_cache=False)
    seqs_j, spk_j = jdataset.find_all_seqs(str(tmp_path), extension=".wav",
                                           load_cache=False)
    assert seqs_t == seqs_j and spk_t == spk_j and len(seqs_t) == 4
    from cpc_audio_tpu.data import audio_io as jaudio_io
    path = os.path.join(str(tmp_path), seqs_t[0][1])
    np.testing.assert_array_equal(audio_io.decode_file(path),
                                  jaudio_io.decode_file(path))


def test_native_copy_loads_the_shared_library():
    """The port's ops/native.py loads the top-level native/ build, the
    one native/*.cc the two packages share."""
    if native.available():
        assert native._LIB_PATH == os.path.join(REPO, "native",
                                                "libcpc_native.so")
    assert os.path.dirname(native._NATIVE_DIR) == REPO


def test_train_main_runs_on_the_gpu_or_raises():
    """No device means cuda:0: without a CUDA device main() raises rather
    than fall back to the CPU; device='cpu' is the caller's choice."""
    assert ttrain.resolve_device("cpu") == torch.device("cpu")
    argv = ["--pathDB", "/nonexistent"]
    if torch.cuda.is_available():
        assert ttrain.resolve_device() == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttrain.main(argv)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttrain.resolve_device(None)
    # the CPU, asked for, gets as far as the data (no such directory)
    assert ttrain.main(argv, device="cpu") == 1


def test_loading_a_jax_checkpoint_imports_no_jax(tmp_path):
    """In a fresh interpreter the port loads a JAX-format checkpoint (its
    pickle holds optax's state classes) into a model and a train state;
    afterwards none of jax, flax, optax or the JAX package is imported."""
    import subprocess
    import sys

    import jax
    import optax
    from cpc_audio_tpu.models import build_model as jbuild_model
    cfg = jconfig.CPCConfig(hiddenEncoder=32, hiddenGar=32, nPredicts=2,
                            negativeSamplingExt=4, sizeWindow=3200)
    jmodel = jbuild_model(cfg)
    params = jmodel.init({"params": jax.random.PRNGKey(0)},
                         np.zeros((1, 1, 3200), np.float32))["params"]
    opt = optax.chain(optax.scale_by_adam(), optax.scale(-1.0))
    jckpt.save_checkpoint(params, {}, opt.init({"model": params,
                                                "criterion": {}}),
                          params, str(tmp_path / "checkpoint_0.pt"))
    jckpt.save_args_sidecar(str(tmp_path), cfg)
    script = f"""
import sys
from cpc_audio_tpu_torch.checkpoint import load_checkpoint
from cpc_audio_tpu_torch.feature_loader import load_model
path = {str(tmp_path / "checkpoint_0.pt")!r}
data = load_checkpoint(path)
assert data["format"] == "cpc_audio_tpu", data["format"]
(count, mu, nu), empty = data["optimizer"]
assert empty == () and set(mu) == {{"model", "criterion"}}
model, hg, he = load_model([path], device="cpu")
assert (hg, he) == (32, 32)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "cpc_audio_tpu"))
assert not bad, bad
print("ok")
"""
    r = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]


def test_eval_modules_import_no_jax(tmp_path):
    """In a fresh interpreter every module of cpc_audio_tpu_torch.eval
    imports, and the ABX CLI runs from_pre_computed (its host DTW and its
    --on_device path on the CPU); afterwards none of jax, flax, optax or
    the JAX package is imported."""
    import subprocess
    import sys

    rng = np.random.RandomState(0)
    feats = tmp_path / "feats"
    feats.mkdir()
    lines = ["#file onset offset #phone prev next speaker"]
    for f in range(4):
        np.save(str(feats / f"f{f}.npy"),
                rng.randn(40, 6).astype(np.float32))
        for s in range(6):
            lines.append(f"f{f} {0.05 * s:.2f} {0.05 * s + 0.04:.2f} "
                         f"{'ab'[s % 2]} x y s{f % 2}")
    item = tmp_path / "t.item"
    item.write_text("\n".join(lines) + "\n")
    script = f"""
import importlib, json, os, pkgutil, sys
import cpc_audio_tpu_torch.eval as ev
names = [m.name for m in pkgutil.walk_packages(ev.__path__, ev.__name__ + ".")]
for name in names:
    importlib.import_module(name)
assert "cpc_audio_tpu_torch.eval.common_voices" in names, names
from cpc_audio_tpu_torch.eval import abx_cli
for i, extra in enumerate(([], ["--on_device"])):
    out = os.path.join({str(tmp_path)!r}, f"out{{i}}")
    assert abx_cli.main(["from_pre_computed", {str(item)!r},
                         {str(feats)!r}, "--out", out] + extra,
                        device="cpu") == 0
    with open(os.path.join(out, "ABX_scores.json")) as f:
        assert set(json.load(f)) == {{"within", "across"}}
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "cpc_audio_tpu"))
assert not bad, bad
print("ok", len(names))
"""
    r = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and \
        r.stdout.strip().splitlines()[-1].startswith("ok"), \
        r.stdout[-2000:] + r.stderr[-2000:]


def test_parallel_and_profiling_modules_import_no_jax():
    """The multi-rank modules (parallel/distributed.py, utils/profiling.py)
    are among the scanned sources, and in a fresh interpreter they and the
    trainer import none of jax, flax, optax or the JAX package."""
    import subprocess
    import sys

    sources = [os.path.relpath(p, REPO) for p in _port_sources()]
    for name in ("parallel/distributed.py", "utils/profiling.py"):
        assert os.path.join("cpc_audio_tpu_torch", name) in sources, name
    script = """
import sys
from cpc_audio_tpu_torch.parallel import distributed
from cpc_audio_tpu_torch.utils.profiling import ThroughputMeter, profile_trace
from cpc_audio_tpu_torch import train
from cpc_audio_tpu_torch.eval import linear_separability
assert distributed.world() == 1 and distributed.rank() == 0
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "cpc_audio_tpu"))
assert not bad, bad
print("ok")
"""
    r = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]
