#!/usr/bin/env python3
"""K1's float32 16-CTA cluster bodies under other layouts, on one NVIDIA GPU.

Usage, from the root of a checkout:  python3 port_perf/k1_f32_layouts.py

Builds copies of cpc_audio_tpu_torch/csrc/{lstm_fwd,lstm_bwd}.cu whose
float32 layouts (csrc/lstm_fwd.cu `Fwd512F`, `Fwd768F`; csrc/lstm_bwd.cu
`Stream512F`, `Stream768F`: how many k-steps of each warp's slice of W_hh's
two bf16 planes sit in registers (RK), in shared memory (SK), and in how
many ring stages (D) the rest streams from L2) are replaced by each
variant's, into build/k1_f32_layouts/ (one nvcc process a copy, all
started together); prints each copy's registers and spills (ptxas) and
the device time a call (chip_smoke.median_ms) of its float32 forward
(saving residuals) and backward at B 8 / T 256 / H 512, B 32 / T 128 /
H 512 and B 32 / T 128 / H 768, on the same inputs, with a SHA-256 of the
outputs (the same layout order of sums gives the same bits; another
layout may not).  The base copy is the checkout's own layouts.
"""

from __future__ import annotations

import ctypes
import os
import re
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from _ab import build_variants, sha  # noqa: E402
from chip_smoke import gpu_line, median_ms, recurrent_args  # noqa: E402
from cpc_audio_tpu_torch.ops import _build  # noqa: E402

FWD, BWD = "lstm_fwd.cu", "lstm_bwd.cu"
# each variant: {source: {layout name: template arguments}}; the names'
# lines in the sources are `using NAME = FwdLayout<...>;` /
# `StreamLayout<...>;`
VARIANTS = {
    "base": {},
    "fewer registers": {
        FWD: {"Fwd512F": "32, 4, 1, 7, 2, 1, 2",
              "Fwd768F": "48, 2, 4, 10, 2, 1, 2"},
        BWD: {"Stream512F": "32, 2, 8, 2, 2",
              "Stream768F": "48, 0, 4, 2, 2"}},
    "fewest registers": {
        FWD: {"Fwd768F": "48, 2, 2, 10, 2, 1, 2"},
        BWD: {"Stream512F": "32, 0, 8, 2, 2"}},
}
SHAPES = ((8, 256, 512), (32, 128, 512), (32, 128, 768))


def report(out: str) -> list:
    """(kernel, registers, spill bytes) of the float32 cluster bodies."""
    rows, kernel = [], None
    for line in out.splitlines():
        m = re.search(r"entry function '(\S+)'", line)
        if m:
            kernel = m.group(1)
            continue
        if kernel and ("FwdLayout" in kernel or "StreamLayout" in kernel):
            s = re.search(r"(\d+) bytes spill stores", line)
            r = re.search(r"Used (\d+) registers", line)
            if s:
                spill = int(s.group(1))
            if r:
                tag = re.search(r"(Fwd|Stream)Layout(I[^E]*)E", kernel)
                rows.append((tag.group(0) if tag else kernel[:60],
                             int(r.group(1)), spill))
                kernel = None
    return rows


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(gpu_line(), flush=True)
    libs = build_variants(os.path.join(HERE, "build", "k1_f32_layouts"),
                          VARIANTS, (FWD, BWD))
    dev = torch.device("cuda", 0)
    P, I = ctypes.c_void_p, ctypes.c_int
    for name, (so, out) in libs.items():
        print(f"{name}: " + "; ".join(f"{k} {r} registers, {s} bytes spilled"
                                      for k, r, s in report(out)), flush=True)
    for B, T, H in SHAPES:
        g = torch.Generator(device=dev).manual_seed(7)

        def rand(*shape, scale=1.0, dt=torch.float32):
            return (torch.randn(shape, generator=g, device=dev) * scale).to(dt)
        fa, ba = recurrent_args(rand, dev, B, T, H)[:2]
        outs = [torch.empty(B, T, H, device=dev), torch.empty(B, H, device=dev),
                torch.empty(B, H, device=dev),
                torch.empty(B, T, 4 * H, device=dev),
                torch.empty(B, T, H, device=dev)]
        bouts = [torch.empty_like(ba[0]), torch.empty(B, H, device=dev),
                 torch.empty(B, H, device=dev)]
        st = torch.cuda.current_stream().cuda_stream
        print(f"B {B} / T {T} / H {H}, float32, device ms a call:",
              flush=True)
        for name, (so, _) in libs.items():
            lib = ctypes.CDLL(so)
            lib.cpc_lstm_fwd.argtypes = [P] * 11 + [I] * 4 + [P]
            lib.cpc_lstm_bwd.argtypes = [P] * 12 + [I] * 4 + [P]
            lib.cpc_lstm_fwd_scratch.restype = ctypes.c_size_t
            lib.cpc_lstm_bwd_scratch.restype = ctypes.c_size_t
            fs = torch.empty(lib.cpc_lstm_fwd_scratch(B, H, 0),
                             dtype=torch.uint8, device=dev)
            bs = torch.empty(lib.cpc_lstm_bwd_scratch(B, H, 0),
                             dtype=torch.uint8, device=dev)
            # the 16-CTA bodies: no grid barrier
            fptr = [t.data_ptr() for t in list(fa) + outs + [fs]] + [None]
            bptr = [t.data_ptr() for t in list(ba) + bouts + [bs]] + [None]

            def fwd():
                return lib.cpc_lstm_fwd(*fptr, B, T, H, 0, st)

            def bwd():
                return lib.cpc_lstm_bwd(*bptr, B, T, H, 0, st)
            if fwd() != 0 or bwd() != 0:
                raise SystemExit(f"{name}: launch failed")
            torch.cuda.synchronize()
            hashes = (sha(outs), sha(bouts))
            f_ms, b_ms = median_ms(fwd), median_ms(bwd)
            print(f"  {name}: forward {f_ms:.4f} ms (sha256 {hashes[0]}), "
                  f"backward {b_ms:.4f} ms (sha256 {hashes[1]})", flush=True)
        del fa, ba, outs, bouts
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
