"""What the A/B scripts of port_perf share: this checkout's float32
precision policy, SHA-256 digests of outputs, the runs of two checkouts
in turns (other, this, this, other; each in a process of its own, each
building its kernels from its own sources at first use) and the report
of which outputs reruns and the two checkouts give bit for bit.

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


def in_turns(script: str, other: str) -> list:
    """[(who, root, result)] of ``script --one root`` for the other
    checkout, this one, this one and the other, in that order."""
    runs = []
    for who, root in (("other", other), ("this", HERE), ("this", HERE),
                      ("other", other)):
        r = subprocess.run([sys.executable, os.path.abspath(script), "--one",
                            root], capture_output=True, text=True)
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


def main(script: str, one, report, keys, doc: str) -> None:
    """``script --one ROOT`` measures ROOT; ``script OTHER`` runs both
    checkouts in turns, reports each run and then bit identity."""
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        one(sys.argv[2])
        return
    if len(sys.argv) != 2:
        raise SystemExit(doc)
    runs = in_turns(script, os.path.abspath(sys.argv[1]))
    for who, root, result in runs:
        report(who, root, result)
    bit_identity(runs, keys)
