#!/usr/bin/env python3
"""Whether two checkouts compile the GEMM core's other users to the same
machine code: K3's and K6's sources, which include csrc/gemm_tc.cuh.

Usage, from the root of a checkout (needs nvcc and cuobjdump, no GPU):
    python3 port_perf/sass_same.py OTHER_CHECKOUT [--drop-arg ARG ...]
        [SOURCE.cu ...]

Builds each source (by default layer_tail_tc.cu, attention_block_fwd.cu
and attention_block_bwd.cu) of both checkouts into build/sass_same/ with
the package's nvcc flags (one nvcc process for each source and checkout,
all started together), disassembles the objects (cuobjdump -sass) and
prints, for each source, how many kernels each holds and which kernels'
SASS differs (the instructions only: addresses, encodings, the file's own
header and the hash an anonymous namespace's name carries are left
out), and which kernels only one checkout has.  ``--drop-arg ARG`` takes
a mangled template argument out of this checkout's names first: a
kernel template given a new trailing argument whose default keeps the
old kernel (``bool CL = false`` mangles as ``Lb0E``) is compared with
the old kernel of the other checkout.  An edit of a shared header that
leaves every kernel the same changes none of their code generation.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join("cpc_audio_tpu_torch", "csrc")
SOURCES = ("layer_tail_tc.cu", "attention_block_fwd.cu",
           "attention_block_bwd.cu")


def compile_(root: str, source: str, out: str):
    """(nvcc process, object path) building ``root``'s ``source`` in a
    copy of its csrc/ at ``out``."""
    sys.path.insert(0, HERE)
    from cpc_audio_tpu_torch.ops import _build
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(os.path.join(root, SRC), out)
    obj = os.path.join(out, source + ".o")
    with open(obj + ".log", "w") as log:
        return subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-c",
                                 "-o", obj, os.path.join(out, source)],
                                stdout=log, stderr=subprocess.STDOUT), obj


def kernels(root: str, proc, obj: str, drop=()) -> dict:
    """{kernel: its SASS instructions} of the object ``proc`` builds, the
    mangled template arguments ``drop`` taken out of the names."""
    from cpc_audio_tpu_torch.ops import _build
    if proc.wait() != 0:
        with open(obj + ".log") as log:
            raise SystemExit(f"{root}: nvcc failed\n{log.read()[-3000:]}")
    dump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([dump, "-sass", obj], capture_output=True,
                          text=True, check=True).stdout
    found = {}
    for chunk in re.split(r"\n\s*Function : ", sass)[1:]:
        # an anonymous namespace's mangled name carries a hash of its file
        name = re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]+",
                      "_GLOBAL__N_", chunk.split("\n", 1)[0].strip())
        for arg in drop:
            name = name.replace(arg, "")
        found[name] = re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", chunk)
    return found


def main() -> None:
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    other = os.path.abspath(sys.argv[1])
    args, drop = sys.argv[2:], []
    while "--drop-arg" in args:
        at = args.index("--drop-arg")
        drop.append(args[at + 1])
        del args[at:at + 2]
    sources = args or SOURCES
    builds = {(source, who): (root, *compile_(
        root, source, os.path.join(HERE, "build", "sass_same", source, who)))
        for source in sources
        for who, root in (("this", HERE), ("other", other))}
    for source in sources:
        mine = kernels(*builds[(source, "this")], drop)
        theirs = kernels(*builds[(source, "other")])
        both = set(mine) & set(theirs)
        differ = sorted(k for k in both if mine[k] != theirs[k])
        only = sorted(set(mine) - both), sorted(set(theirs) - both)
        print(f"{source}: {len(mine)} kernels here, {len(theirs)} in the "
              f"other checkout; SASS of the {len(both)} in both "
              f"{'identical' if not differ else 'differs'}"
              + (f" in {len(differ)}: " + "; ".join(d[:90] for d in differ)
                 if differ else "")
              + "".join(f"; only {where} ({len(ks)}): "
                        + "; ".join(k[:90] for k in ks)
                        for where, ks in zip(("here", "there"), only) if ks),
              flush=True)


if __name__ == "__main__":
    main()
