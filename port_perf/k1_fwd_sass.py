#!/usr/bin/env python3
"""Where the spills of K1's forward cluster bodies fall, from their SASS.

Usage, from the root of a checkout (needs nvcc and cuobjdump, no GPU):
    python3 port_perf/k1_fwd_sass.py [OTHER_CHECKOUT]

Builds csrc/lstm_fwd.cu of this checkout (and of OTHER_CHECKOUT) into
build/k1_fwd_sass/ with the package's nvcc flags, disassembles it
(cuobjdump -sass) and prints, for each cluster-body kernel: its layout
(`FwdLayout<J, KS, RK, SK, D, NP, PL, ...>`), registers and spill bytes
(ptxas), and in the step loop (the longest backward branch) its
instructions and the local-memory loads and stores (LDL / STL: spills)
before the step's product (the first HMMA), within it, and after it,
where the cell runs on the path to the step's multicast.  A reload there
waits on the L1, mostly given to shared memory, or on L2.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join("cpc_audio_tpu_torch", "csrc")


def build(root: str, out: str) -> tuple:
    """(SASS, ptxas report) of ``root``'s lstm_fwd.cu."""
    sys.path.insert(0, HERE)
    from cpc_audio_tpu_torch.ops import _build
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(os.path.join(root, SRC), out)
    obj = os.path.join(out, "lstm_fwd.o")
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-c", "-o", obj,
                        os.path.join(out, "lstm_fwd.cu")],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise SystemExit(f"{root}: nvcc failed\n{r.stderr[-3000:]}")
    dump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([dump, "-sass", obj], capture_output=True,
                          text=True, check=True).stdout
    return sass, r.stdout + r.stderr


def ptxas(report: str) -> dict:
    """{kernel: (registers, spill store bytes)}."""
    out, kernel, spill = {}, None, 0
    for line in report.splitlines():
        m = re.search(r"entry function '(\S+)'", line)
        if m:
            kernel = m.group(1)
        s = re.search(r"(\d+) bytes spill stores", line)
        if s:
            spill = int(s.group(1))
        r = re.search(r"Used (\d+) registers", line)
        if r and kernel:
            out[kernel] = (int(r.group(1)), spill)
            kernel = None
    return out


def loop_spills(body: str) -> tuple:
    """(step-loop instructions, spill ops before / in / after the
    product) of one kernel's SASS."""
    ins = [(int(a, 16), t.strip()) for a, t in
           re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
    back = [(a, int(m.group(1), 16)) for a, t in ins
            for m in [re.search(r"BRA\S*\s.*?0x([0-9a-f]+)", t)]
            if m and int(m.group(1), 16) < a]
    if not back:
        return len(ins), 0, 0, 0
    hi, lo = max(back, key=lambda b: b[0] - b[1])
    loop = [t for a, t in ins if lo <= a <= hi]
    mma = [i for i, t in enumerate(loop) if "HMMA" in t]
    first, last = (mma[0], mma[-1]) if mma else (len(loop), len(loop))

    def spills(part):
        return sum(1 for t in part if re.search(r"\b(LDL|STL)\b", t))
    return (len(loop), spills(loop[:first]), spills(loop[first:last]),
            spills(loop[last:]))


def main() -> None:
    roots = [("this", HERE)] + [("other", os.path.abspath(a))
                                for a in sys.argv[1:2]]
    for who, root in roots:
        sass, report = build(root, os.path.join(HERE, "build",
                                                "k1_fwd_sass", who))
        regs = ptxas(report)
        for chunk in re.split(r"\n\s*Function : ", sass)[1:]:
            name = chunk.split("\n", 1)[0].strip()
            if "FwdLayout" not in name:
                continue
            args = re.findall(r"Li(\d+)E", re.search(
                r"FwdLayout(I(?:Li\d+E)+)E", name).group(1))
            layout = ", ".join(args)
            dtype = "float32" if args[6] == "2" else "bf16"   # PL planes
            n, pre, mid, post = loop_spills(chunk)
            r, s = regs.get(name, (None, None))
            print(f"{who} FwdLayout<{layout}> {dtype}: {r} registers, {s} "
                  f"bytes spilled; step loop {n} instructions, spill ops "
                  f"before the product {pre}, in it {mid}, after it (the "
                  f"cell) {post}", flush=True)


if __name__ == "__main__":
    main()
