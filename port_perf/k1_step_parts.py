#!/usr/bin/env python3
"""Where a step of K1's 16-CTA cluster bodies, or of its grid bodies,
goes, on one NVIDIA GPU.

Usage, from the root of a checkout:  python3 port_perf/k1_step_parts.py
                                     python3 port_perf/k1_step_parts.py --grid

Builds copies of cpc_audio_tpu_torch/csrc/{lstm_fwd,lstm_bwd}.cu, each
with one part of a recurrence step removed (the exchange, the cluster
barrier, the cell, the product, the stream of W_hh from L2), into
build/k1_step_parts/ (one nvcc process a copy, all started together), and
prints the device time a step of each copy's bf16 forward and backward
at B 8 / T 256 / H 512 and B 32 / T 128 / H 768 (chip_smoke.median_ms,
same inputs).  With --grid, the copies remove a part of the grid bodies'
step instead (csrc/rnn_grid.cuh: the exchange through L2, the wait of the
grid barrier, the product, the cell or elementwise part, the stream of
W_hh's chunks) and the times are
at B 32 / T 128 / H 1056 (W_hh in shared memory) and B 4 / T 128 / H 4096
(streamed).  The copies compute wrong values; only their times mean
anything: the base's time less a copy's is what that part costs a step
where nothing else hides it.  Each edit names the exact source text it
removes and the script stops if a source no longer holds it.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from chip_smoke import gpu_line, median_ms, recurrent_args  # noqa: E402
from cpc_audio_tpu_torch.ops import _build  # noqa: E402

FWD, BWD, HDR = "lstm_fwd.cu", "lstm_bwd.cu", "rnn_cluster.cuh"
NEVER = "n_steps < 0"      # a condition no launch meets
# (file, text, replacement) edits of each variant
PARTS = {
    "base": [],
    # forward: no multicast, no wait for it; backward (both cluster
    # bodies): no push over distributed shared memory
    "no exchange": [
        (HDR, "store_remote(slot + ", "if (kRows < 0) store_remote(slot + "),
        (FWD, "      rnn::mbar_wait(full + cur,",
         f"      if ({NEVER}) rnn::mbar_wait(full + cur,"),
        (FWD, "    if (tid == 0 && more) rnn::mbar_expect(",
         f"    if ({NEVER}) rnn::mbar_expect("),
        (FWD, "      rnn::multicast(atile",
         f"      if ({NEVER}) rnn::multicast(atile"),
        (BWD, "rnn::store_remote(slot + ",
         f"if ({NEVER}) rnn::store_remote(slot + ")],
    # the split cluster barrier (forward at H 768, backward at H 768)
    "no cluster barrier": [
        (FWD, "    if (L::NP == 1) rnn::cluster_arrive();", ""),
        (FWD, "    if (L::NP == 1) rnn::cluster_wait();", ""),
        (BWD, "    rnn::cluster_arrive();    // this CTA's reads of its "
              "receive buffer are done", ""),
        (BWD, "    rnn::cluster_wait();      // every CTA is done reading "
              "its receive buffer", "")],
    # forward: the cell and the step's outputs
    "no cell": [
        (FWD, "    if (owner) {\n      const int e = p;",
         f"    if (owner && {NEVER}) {{\n      const int e = p;"),
        (FWD, "    if (valid) {\n      const size_t bt",
         f"    if (valid && {NEVER}) {{\n      const size_t bt")],
    "no product": [
        (FWD, "    S::product(", f"    if ({NEVER}) S::product("),
        (BWD, "    S::product(", f"    if ({NEVER}) S::product(")],
    # the streamed remainder's copies (H 768)
    "no stream": [
        (HDR, "        fill(ring + d * STAGE, d);", "        (void)fill;"),
        (HDR, "        fill(stage, (q + D) % QK);", "        (void)fill;")],
}
SHAPES = ((8, 256, 512), (32, 128, 768))
GRID = "rnn_grid.cuh"
GNEVER = "T < 0"           # the same, in the grid kernels
GRID_PARTS = {
    "base": [],
    # forward: no h loads from the exchange, no h stores into it; backward:
    # no partial carries stored, none summed
    "no exchange": [
        (GRID, "        if (nt < NT) f[nt] = __ldcg(",
         f"        if (nt < NT && {GNEVER}) f[nt] = __ldcg("),
        (GRID, "      if (t + 1 < T) put_h(exch,",
         f"      if ({GNEVER}) put_h(exch,"),
        (GRID, "          *reinterpret_cast<float4*>(\n              out + ",
         f"          if ({GNEVER}) *reinterpret_cast<float4*>(\n"
         f"              out + "),
        (GRID, "      for (int src = grp * ncta / S; src < s1; ++src) {",
         f"      for (int src = grp * ncta / S; src < s1 && {GNEVER}; "
         f"++src) {{")],
    # the grid barrier's wait (the arrivals stay)
    "no barrier wait": [
        (GRID, "    while (((old ^ ld_acquire(bar)) & 0x80000000u) == 0) {",
         "    while (old == 1u && ((old ^ ld_acquire(bar)) & 0x80000000u) "
         "== 2u) {")],
    # the tensor-core products (and the W_hh fragments they read)
    "no product": [
        (GRID, "    for (int q = 0; q < Q; ++q) {\n      uint4 hf[4];",
         f"    for (int q = 0; q < Q && {GNEVER}; ++q) {{\n"
         f"      uint4 hf[4];"),
        (GRID, "      for (int np = 0; 2 * np < NT; ++np) {",
         f"      for (int np = 0; 2 * np < NT && {GNEVER}; ++np) {{")],
    # the cell (forward) and the elementwise part (backward)
    "no cell": [
        (GRID, "      const float2 h = Cell::step(p, s, st, x, pre, ib, k, t);",
         f"      const float2 h = {GNEVER} ? Cell::step(p, s, st, x, pre, "
         f"ib, k, t) : pre[0][0] > 0.0f ? make_float2(pre[0][0], "
         f"pre[1][1]) : make_float2(0.0f, 0.0f);"),
        (GRID, "      Cell::step(p, s, st, r, carry, first, ib, k, t, dg);",
         f"      if ({GNEVER}) Cell::step(p, s, st, r, carry, first, ib, k, "
         f"t, dg);\n      else for (int g = 0; g < G; ++g) dg[g][0] = "
         f"dg[g][1] = carry.x;")],
    # not a part removed: both bodies split W_hh over half the SMs (J
    # twice as wide, half the CTAs: the backward's exchange halves)
    "half the CTAs": [
        (GRID, "  const int sms = sm_count();\n  const int rows",
         "  const int sms = sm_count() / 2;\n  const int rows")],
    # the refills of the streamed stages (H 4096)
    "no W stream": [
        (GRID, "        fill(stage, kb + (q + D) % Q);", "        (void)0;"),
        (GRID, "        fill(stage, cb + (q + DB) % Q);", "        (void)0;")],
}
GRID_SHAPES = ((32, 128, 1056), (4, 128, 4096))


def build_all(root: str, parts: dict = PARTS) -> dict:
    """{variant: shared library path}, built in parallel."""
    shutil.rmtree(root, ignore_errors=True)
    procs = {}
    for name, edits in parts.items():
        d = os.path.join(root, name.replace(" ", "_"))
        shutil.copytree(_build.CSRC_DIR, d)
        for f, text, new in edits:
            path = os.path.join(d, f)
            with open(path) as fh:
                src = fh.read()
            if text not in src:
                raise SystemExit(f"{name}: {f} no longer holds {text!r}")
            with open(path, "w") as fh:
                fh.write(src.replace(text, new))
        so = os.path.join(d, "lib.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS[:-2], "-shared", "-o", so,
               os.path.join(d, FWD), os.path.join(d, BWD)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so)
    libs = {}
    for name, (p, so) in procs.items():
        out = p.communicate()[0]
        if p.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{out}")
        libs[name] = so
    return libs


def grid_main() -> None:
    """The grid bodies' variants at GRID_SHAPES, bf16, through the C entry
    points with each library's own scratch and a barrier word."""
    libs = build_all(os.path.join(HERE, "build", "k1_step_parts_grid"),
                     GRID_PARTS)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(1)

    def rand(*shape, scale=1.0, dt=torch.bfloat16):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dt)
    P, I = ctypes.c_void_p, ctypes.c_int
    for B, T, H in GRID_SHAPES:
        fa, ba = recurrent_args(rand, dev, B, T, H)[:2]
        outs = [torch.empty(B, T, H, dtype=torch.bfloat16, device=dev),
                torch.empty(B, H, dtype=torch.bfloat16, device=dev),
                torch.empty(B, H, dtype=torch.bfloat16, device=dev),
                torch.empty(B, T, 4 * H, device=dev),
                torch.empty(B, T, H, device=dev)]
        bouts = [torch.empty_like(ba[0]), torch.empty(B, H, device=dev),
                 torch.empty(B, H, device=dev)]
        st = torch.cuda.current_stream().cuda_stream
        print(f"B {B} / T {T} / H {H}, bf16, grid bodies, device us a "
              f"step:", flush=True)
        for name, so in libs.items():
            lib = ctypes.CDLL(so)
            lib.cpc_lstm_fwd.argtypes = [P] * 11 + [I] * 4 + [P]
            lib.cpc_lstm_bwd.argtypes = [P] * 12 + [I] * 4 + [P]
            for fn in ("cpc_lstm_fwd_scratch", "cpc_lstm_bwd_scratch"):
                getattr(lib, fn).restype = ctypes.c_size_t
                getattr(lib, fn).argtypes = [I] * 3
            fs = torch.empty(lib.cpc_lstm_fwd_scratch(B, H, 1),
                             dtype=torch.uint8, device=dev)
            bs = torch.empty(lib.cpc_lstm_bwd_scratch(B, H, 1),
                             dtype=torch.uint8, device=dev)
            bar = torch.zeros(4, dtype=torch.int32, device=dev)
            fptr = [t.data_ptr() for t in list(fa) + outs + [fs, bar]]
            bptr = [t.data_ptr() for t in list(ba) + bouts + [bs, bar]]

            def fwd():
                return lib.cpc_lstm_fwd(*fptr, B, T, H, 1, st)

            def bwd():
                return lib.cpc_lstm_bwd(*bptr, B, T, H, 1, st)
            if fwd() != 0 or bwd() != 0:
                raise SystemExit(f"{name}: launch failed")
            f_ms, b_ms = median_ms(fwd), median_ms(bwd)
            print(f"  {name}: forward {f_ms / T * 1e3:.2f} ({f_ms:.4f} ms a "
                  f"call), backward {b_ms / T * 1e3:.2f} ({b_ms:.4f} ms)",
                  flush=True)
        del fa, ba, outs, bouts
        torch.cuda.empty_cache()


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(gpu_line(), flush=True)
    if sys.argv[1:] == ["--grid"]:
        grid_main()
        return
    libs = build_all(os.path.join(HERE, "build", "k1_step_parts"))
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(1)

    def rand(*shape, scale=1.0, dt=torch.bfloat16):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dt)
    P, I = ctypes.c_void_p, ctypes.c_int
    for B, T, H in SHAPES:
        fa, ba = recurrent_args(rand, dev, B, T, H)[:2]
        outs = [torch.empty(B, T, H, dtype=torch.bfloat16, device=dev),
                torch.empty(B, H, dtype=torch.bfloat16, device=dev),
                torch.empty(B, H, dtype=torch.bfloat16, device=dev),
                torch.empty(B, T, 4 * H, device=dev),
                torch.empty(B, T, H, device=dev),
                torch.zeros(1 << 20, dtype=torch.uint8, device=dev)]
        bouts = [torch.empty_like(ba[0]), torch.empty(B, H, device=dev),
                 torch.empty(B, H, device=dev)]
        st = torch.cuda.current_stream().cuda_stream
        print(f"B {B} / T {T} / H {H}, bf16, device us a step:", flush=True)
        for name, so in libs.items():
            lib = ctypes.CDLL(so)
            lib.cpc_lstm_fwd.argtypes = [P] * 11 + [I] * 4 + [P]
            lib.cpc_lstm_bwd.argtypes = [P] * 12 + [I] * 4 + [P]
            # the 16-CTA bodies: no grid barrier; the bf16 backward no
            # scratch
            fptr = [t.data_ptr() for t in list(fa) + outs] + [None]
            bptr = [t.data_ptr() for t in list(ba) + bouts] + [None, None]

            def fwd():
                return lib.cpc_lstm_fwd(*fptr, B, T, H, 1, st)

            def bwd():
                return lib.cpc_lstm_bwd(*bptr, B, T, H, 1, st)
            if fwd() != 0 or bwd() != 0:
                raise SystemExit(f"{name}: launch failed")
            f_ms, b_ms = median_ms(fwd), median_ms(bwd)
            print(f"  {name}: forward {f_ms / T * 1e3:.2f} ({f_ms:.4f} ms a "
                  f"call), backward {b_ms / T * 1e3:.2f} ({b_ms:.4f} ms)",
                  flush=True)
        del fa, ba, outs, bouts
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
