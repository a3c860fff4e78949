#!/usr/bin/env python3
"""A 16-CTA all-gather on one NVIDIA GPU, three ways (port_perf/allgather.cu):
per-thread stores over distributed shared memory plus a cluster barrier,
bulk copies shared -> remote shared with mbarriers, and one multicast bulk
copy a CTA from global memory (L2) with mbarriers; and the cluster barrier
alone.  Prints the device time a step (chip_smoke.median_ms over 256-step
launches) at the block sizes of K1's exchanges: 2048 and 3072 bytes (h's
bf16 hi and lo of 16 rows by 32 or 48 units), 4096 and 6144.  A launch
whose blocks did not all arrive fails the script.

Usage, from the root of a checkout:  python3 port_perf/allgather.py
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from chip_smoke import gpu_line, median_ms  # noqa: E402
from cpc_audio_tpu_torch.ops import _build  # noqa: E402

MODES = ("stores", "bulk", "multicast", "barrier")
STEPS = 256


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(gpu_line(), flush=True)
    out = os.path.join(HERE, "build", "port_perf")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, "allgather.so")
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS[:-2], "-shared",
                        "-o", so, os.path.join(HERE, "port_perf",
                                               "allgather.cu")],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise SystemExit(f"nvcc failed\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(so)
    lib.allgather.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
    dev = torch.device("cuda", 0)
    scratch = torch.zeros(2 * 2 * 16 * 6144, dtype=torch.uint8, device=dev)
    bad = torch.zeros(1, dtype=torch.int32, device=dev)
    st = torch.cuda.current_stream().cuda_stream
    for blk in (2048, 3072, 4096, 6144):
        for clusters in (1, 2):
            line = []
            for mode, name in enumerate(MODES):
                def call():
                    return lib.allgather(mode, blk, clusters, STEPS,
                                         scratch.data_ptr(), bad.data_ptr(),
                                         st)
                if call() != 0:
                    raise SystemExit(f"{name}: launch failed")
                ms = median_ms(call)
                line.append(f"{name} {ms / STEPS * 1e3:.3f}")
            torch.cuda.synchronize()
            if bad.item() != 0:
                raise SystemExit(f"{bad.item()} blocks did not arrive")
            print(f"  {blk} bytes, {clusters} cluster(s), us a step: "
                  + ", ".join(line), flush=True)


if __name__ == "__main__":
    main()
