#!/usr/bin/env python3
"""The grid backward's exchange alone, against the all-gather it was chosen
over, on one NVIDIA GPU (port_perf/grid_exchange.cu).

K1's and K4's grid backward (csrc/rnn_grid.cuh) reduce-scatters each
step's partial carries through L2: every CTA stores its B x H partial
(135 KB at B 32 / H 1056), a grid barrier, then every CTA sums its own
units over all CTAs' partials.  The alternative all-gathers dgates: every
CTA stores its B x G J values (4 KB), a grid barrier, then reads all of
them (540 KB a CTA).  This prints the device time a step of each
exchange, and of the grid barrier alone, over 128-step cooperative
launches on as many CTAs as the grid bodies use (chip_smoke.median_ms), at
the --hiddenGar 1056 path's B 32 / H 1056 (K1) and the 4096 model's B 4 /
H 4096.  A step whose values did not all arrive fails the script.

Usage, from the root of a checkout:  python3 port_perf/grid_exchange.py
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
from cpc_audio_tpu_torch.ops import _build, lstm  # noqa: E402

MODES = ("reduce-scatter", "all-gather", "barrier")
STEPS = 128
SHAPES = ((32, 1056), (4, 4096))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(gpu_line(), flush=True)
    out = os.path.join(HERE, "build", "port_perf")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, "grid_exchange.so")
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS[:-2], "-shared",
                        "-o", so, os.path.join(HERE, "port_perf",
                                               "grid_exchange.cu")],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise SystemExit(f"nvcc failed\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.grid_exchange.argtypes = [I] * 7 + [P] * 4
    lib.grid_exchange_bytes.argtypes = [I] * 6
    lib.grid_exchange_bytes.restype = ctypes.c_size_t
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bar = torch.zeros(4, dtype=torch.int32, device=dev)
    bad = torch.zeros(1, dtype=torch.int32, device=dev)
    st = torch.cuda.current_stream().cuda_stream
    G = 4
    for B, H in SHAPES:
        s = lstm.grid_shape(H, G, sms, B)
        J, ncta = s["J"], s["ncta"]
        line = []
        for mode, name in enumerate(MODES):
            buf = torch.empty(lib.grid_exchange_bytes(mode, ncta, B, H, G,
                                                      J),
                              dtype=torch.uint8, device=dev)

            def call():
                return lib.grid_exchange(mode, ncta, STEPS, B, H, G, J,
                                         buf.data_ptr(), bar.data_ptr(),
                                         bad.data_ptr(), st)
            if call() != 0:
                raise SystemExit(f"{name}: launch failed")
            ms = median_ms(call)
            line.append(f"{name} {ms / STEPS * 1e3:.2f}")
            torch.cuda.synchronize()
            if bad.item() != 0:
                raise SystemExit(f"{name}: {bad.item()} values did not "
                                 f"arrive")
        print(f"  B {B} / H {H} ({ncta} CTAs of J {J} units), us a step: "
              + ", ".join(line), flush=True)


if __name__ == "__main__":
    main()
