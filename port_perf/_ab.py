"""What the A/B scripts of port_perf share: this checkout's float32
precision policy, SHA-256 digests of outputs, the runs of two checkouts
in turns (other, this, this, other; each in a process of its own, each
building its kernels from its own sources at first use) and the report
of which outputs reruns and the two checkouts give bit for bit.

The layout scripts (k1_f32_layouts.py, k1_fwd_layouts.py) build their
variants with ``build_variants``.

A script defines ``one(root)``, which measures the checkout at ``root``
and prints one JSON object {case: {...}} as its last line, and a
``report(who, root, result)`` that prints one run's numbers; then its
``main`` is ``_ab.main(__file__, one, report, hash_keys)``.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def precision_policy() -> None:
    """This checkout's float32 precision policy
    (cpc_audio_tpu_torch/_common.py ``precision_policy``: TF32 off), run
    from its file without importing the package, so that a run of another
    checkout's package is held to this checkout's policy."""
    spec = importlib.util.spec_from_file_location(
        "_cpc_precision", os.path.join(HERE, "cpc_audio_tpu_torch",
                                       "_common.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.precision_policy()


def sha(tensors) -> str:
    """The first 16 hex digits of a SHA-256 of the tensors' bytes."""
    import torch
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def in_turns(script: str, other: str, extra=()) -> list:
    """[(who, root, result)] of ``script --one root [extra ...]`` for the
    other checkout, this one, this one and the other, in that order."""
    runs = []
    for who, root in (("other", other), ("this", HERE), ("this", HERE),
                      ("other", other)):
        r = subprocess.run([sys.executable, os.path.abspath(script), "--one",
                            root, *extra], capture_output=True, text=True)
        if r.returncode != 0:
            raise SystemExit(f"{root}: failed\n{r.stderr[-3000:]}")
        runs.append((who, root, json.loads(r.stdout.strip().splitlines()[-1])))
    return runs


def bit_identity(runs: list, keys) -> None:
    """For each case and hash key (e.g. "fwd_sha256") of the runs: whether
    each checkout's reruns agree, and whether the two checkouts do."""
    seen = {}
    for who, _, result in runs:
        for case, t in result.items():
            for key in keys:
                if key in t:
                    seen.setdefault((case, key, who), set()).add(str(t[key]))
    for case, key in sorted({(c, k) for c, k, _ in seen}):
        this, other = (seen.get((case, key, w), set())
                       for w in ("this", "other"))
        print(f"{case} {key}: reruns bit-identical: this "
              f"{'yes' if len(this) == 1 else 'NO'}, other "
              f"{'yes' if len(other) == 1 else 'NO'}; the two checkouts' "
              f"outputs {'bit-identical' if this == other else 'differ'}",
              flush=True)


def build_variants(root: str, variants: dict, sources) -> dict:
    """Copies of this checkout's csrc/ under ``root``, one a variant
    {name: {source: {layout name: template arguments}}} with those
    layouts' lines (`using NAME = Type<...>;`, a K1 `...Layout` or a
    `gm::Tile`) replaced, each built from ``sources`` into one shared
    library by its own nvcc process, all started together: {name:
    (library path, nvcc output)}."""
    import re
    import shutil
    sys.path.insert(0, HERE)
    from cpc_audio_tpu_torch.ops import _build
    shutil.rmtree(root, ignore_errors=True)
    procs = {}
    for i, (name, edits) in enumerate(variants.items()):
        d = os.path.join(root, str(i))
        shutil.copytree(_build.CSRC_DIR, d)
        for f, layouts in edits.items():
            path = os.path.join(d, f)
            with open(path) as fh:
                src = fh.read()
            for layout, targs in layouts.items():
                pat = re.compile(rf"(using {layout} = [\w:]+<)[^>]*(>;)")
                if not pat.search(src):
                    raise SystemExit(f"{name}: no layout {layout} in {f}")
                src = pat.sub(rf"\g<1>{targs}\g<2>", src)
            with open(path, "w") as fh:
                fh.write(src)
        so = os.path.join(d, "lib.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", so,
               *(os.path.join(d, f) for f in sources)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so)
    libs = {}
    for name, (p, so) in procs.items():
        out = p.communicate()[0]
        if p.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{out[-4000:]}")
        libs[name] = (so, out)
    return libs


def main(script: str, one, report, keys, doc: str) -> None:
    """``script --one ROOT`` measures ROOT; ``script OTHER`` runs both
    checkouts in turns, reports each run and then bit identity.  Words
    after OTHER pass on to each ``--one`` run (its ``sys.argv[3:]``)."""
    if len(sys.argv) >= 3 and sys.argv[1] == "--one":
        one(sys.argv[2])
        return
    if len(sys.argv) < 2:
        raise SystemExit(doc)
    runs = in_turns(script, os.path.abspath(sys.argv[1]), sys.argv[2:])
    for who, root, result in runs:
        report(who, root, result)
    bit_identity(runs, keys)
