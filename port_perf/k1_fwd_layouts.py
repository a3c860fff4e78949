#!/usr/bin/env python3
"""K1's and K4's forward cluster bodies at H 256 under other layouts, on one
NVIDIA GPU.

Usage, from the root of a checkout:  python3 port_perf/k1_fwd_layouts.py

Builds copies of cpc_audio_tpu_torch/csrc/{lstm_fwd,gru_fwd}.cu whose H 256
layouts (`Fwd256`, `Fwd256F`: `FwdLayout<J, KS, RK, SK, D, NP, PL, C, G>`,
both in csrc/rnn_cluster_fwd.cuh) are replaced by each variant's (the cluster
size C, 8 or 16, with J = 256 / C units a CTA; KS parts of the product; RK
k-steps of a warp's slice in registers, SK in shared memory) into
build/k1_fwd_layouts/ (one nvcc process a copy, all started together);
prints each copy's registers and spills (ptxas) and the device time a
call (chip_smoke.median_ms) of K1's and K4's forward (saving residuals,
as training does) at B 32 / T 128 and at build_feature's B 1 / T 400, in
bf16 and float32, on the same inputs, with a SHA-256 of the outputs.
The base copy is the checkout's own layouts.
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

SOURCES = ("lstm_fwd.cu", "gru_fwd.cu")
# each variant: {source: {layout name: template arguments}}; the names'
# lines in the sources are `using NAME = FwdLayout<...>;`, K1's and K4's
# at H 256 one template of the gate count G in csrc/rnn_cluster_fwd.cuh
HEADER = "rnn_cluster_fwd.cuh"
VARIANTS = {
    "base (C 16, KS 4)": {},
    "C 8, KS 4": {HEADER: {"Fwd256": "32, 4, 4, 0, 1, 2, 1, 8, G",
                           "Fwd256F": "32, 4, 4, 4, 1, 2, 2, 8, G"}},
    "C 16, KS 8": {HEADER: {"Fwd256": "16, 8, 2, 0, 1, 2, 1, 16, G",
                            "Fwd256F": "16, 8, 4, 0, 1, 2, 2, 16, G"}},
    "C 8, KS 2": {HEADER: {"Fwd256": "32, 2, 8, 0, 1, 2, 1, 8, G",
                           "Fwd256F": "32, 2, 4, 12, 1, 2, 2, 8, G"}},
    "C 16, KS 4, float32 slice in shared memory": {
        HEADER: {"Fwd256F": "16, 4, 0, 8, 1, 2, 2, 16, G"}},
}
SHAPES = ((32, 128, 256), (1, 400, 256))


def report(out: str) -> list:
    """(layout, registers, spill bytes) of the H 256 cluster bodies."""
    rows, kernel, spill = [], None, 0
    for line in out.splitlines():
        m = re.search(r"entry function '(\S+)'", line)
        if m:
            kernel = m.group(1) if "fwd_cluster_kernel" in m.group(1) \
                else None
            continue
        if kernel is None:
            continue
        s = re.search(r"(\d+) bytes spill stores", line)
        r = re.search(r"Used (\d+) registers", line)
        if s:
            spill = int(s.group(1))
        if r:
            # FwdLayout<J, KS, RK, SK, D, NP, PL, C, G>
            nums = [int(x) for x in re.findall(r"Li(\d+)E", kernel)][:9]
            if nums[0] * nums[7] == 256:
                rows.append((f"{'K1' if nums[8] == 4 else 'K4'} "
                             f"{'bf16' if nums[6] == 1 else 'float32'} "
                             f"<{', '.join(map(str, nums))}>",
                             int(r.group(1)), spill))
            kernel = None
    return rows


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(gpu_line(), flush=True)
    libs = build_variants(os.path.join(HERE, "build", "k1_fwd_layouts"),
                          VARIANTS, SOURCES)
    dev = torch.device("cuda", 0)
    P, I = ctypes.c_void_p, ctypes.c_int
    for name, (so, out) in libs.items():
        print(f"{name}: " + "; ".join(f"{k} {r} registers, {s} bytes spilled"
                                      for k, r, s in report(out)), flush=True)
    st = torch.cuda.current_stream().cuda_stream
    for dtype in (torch.bfloat16, torch.float32):
        code = _build.DTYPE_CODES[dtype]
        for B, T, H in SHAPES:
            g = torch.Generator(device=dev).manual_seed(7)

            def rand(*shape, scale=1.0, dt=dtype):
                return (torch.randn(shape, generator=g, device=dev)
                        * scale).to(dt)
            la, _, ga, _ = recurrent_args(rand, dev, B, T, H)
            print(f"B {B} / T {T} / H {H}, {str(dtype)[6:]}, device ms a "
                  f"call:", flush=True)
            for name, (so, _) in libs.items():
                lib = ctypes.CDLL(so)
                for kind, args in (("lstm", la), ("gru", ga)):
                    G = 4 if kind == "lstm" else 3
                    launch = getattr(lib, f"cpc_{kind}_fwd")
                    launch.argtypes = [P] * (11 if G == 4 else 10) + \
                        [I] * 4 + [P]
                    scratch_of = getattr(lib, f"cpc_{kind}_fwd_scratch")
                    scratch_of.restype = ctypes.c_size_t
                    scratch = torch.empty(scratch_of(B, H, code),
                                          dtype=torch.uint8, device=dev)
                    outs = [torch.empty(B, T, H, dtype=dtype, device=dev),
                            torch.empty(B, H, dtype=dtype, device=dev)]
                    if G == 4:
                        outs.append(torch.empty(B, H, dtype=dtype,
                                                device=dev))
                    outs += [torch.empty(B, T, G * H, device=dev),
                             torch.empty(B, T, H, device=dev)]
                    ptrs = [t.data_ptr() for t in list(args) + outs
                            + [scratch]] + [None]

                    def fwd():
                        return launch(*ptrs, B, T, H, code, st)
                    if fwd() != 0:
                        raise SystemExit(f"{name}: {kind} launch failed")
                    torch.cuda.synchronize()
                    digest = sha(outs)
                    again = fwd()
                    torch.cuda.synchronize()
                    same = again == 0 and sha(outs) == digest
                    print(f"  {name}: {kind}_fwd {median_ms(fwd):.4f} ms "
                          f"(sha256 {digest}, rerun bit-identical {same})",
                          flush=True)
            del la, ga
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
