#!/usr/bin/env python3
"""K7's GEMM tiles: the forward and backward of this checkout under other
tiles, layer by layer, on one GPU.

Usage, from the root of a checkout:
    python3 port_perf/k7_tiles.py

Builds copies of csrc/conv_ln_{fwd,bwd}.cu with csrc/conv_ln.cuh's tiles
(`TileFwd`, `TileDx`, `TileDW`) replaced (``VARIANTS``; one nvcc process
each, all started together, into build/k7_tiles/), then times each
variant's forward and backward (its C entry points called as
ops/conv_ln.py calls them) at encoder layers 1-4, B 32, C 256
(chip_smoke.conv_layers), in bf16 and float32: device ms a call
(chip_smoke.median_ms), each layer alone and the four together, with
each kernel's registers and spills (ptxas), and whether its outputs
match the unchanged tiles' bit for bit.
"""

from __future__ import annotations

import ctypes
import os
import re
import sys

import _ab
from _ab import HERE, sha

# variant: {layout: template arguments} of csrc/conv_ln.cuh
VARIANTS = {
    "as built": {},
    "Fwd 4 stages": {"TileFwd": "64, 256, 1, 8, 4"},
    "Fwd 64-deep": {"TileFwd": "64, 256, 1, 8, 3, 64"},
    "Fwd 128 x 256, 2 x 8 warps": {"TileFwd": "128, 256, 2, 8"},
    "Dx, DW 32-deep": {"TileDx": "128, 128, 2, 4",
                       "TileDW": "128, 128, 2, 4"},
    "Dx, DW 64-deep, 4 stages": {"TileDx": "128, 128, 2, 4, 4, 64",
                                 "TileDW": "128, 128, 2, 4, 4, 64"},
}
SOURCES = ("conv_ln_fwd.cu", "conv_ln_bwd.cu")
ENTRIES = ("cpc_conv_ln_fwd", "cpc_conv_ln_fwd_scratch", "cpc_conv_ln_bwd",
           "cpc_conv_ln_bwd_scratch")


def ptxas(report: str) -> list:
    """'<kernel> <dtype> <n> registers[ (<b> B spilled)]' of the GEMM
    kernels in an nvcc -Xptxas -v report."""
    out, kernel, spill = [], None, "0"
    for line in report.splitlines():
        m = re.search(r"entry function '_ZN3cpc7conv_ln\d+(fwd|dx|dw)_kernel"
                      r"I(\w+?)E", line)
        if m:
            dt = "bf16" if "bfloat" in m.group(2) else "f32"
            kernel = f"{m.group(1)} {dt}"
        s = re.search(r"(\d+) bytes spill stores", line)
        if s:
            spill = s.group(1)
        r = re.search(r"Used (\d+) registers", line)
        if r and kernel:
            out.append(f"{kernel} {r.group(1)} registers" +
                       ("" if spill == "0" else f" ({spill} B spilled)"))
            kernel = None
    return out


def bind(path: str):
    sys.path.insert(0, HERE)
    from cpc_audio_tpu_torch.ops import _build
    lib = ctypes.CDLL(path)
    for name in ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = _build._SIGNATURES[name]
    return lib


def calls(lib, layer, dy):
    """(forward, backward) of one layer through ``lib``, as
    ops/conv_ln.py calls the entry points; the backward from the
    forward's residuals."""
    import torch
    from cpc_audio_tpu_torch.ops import _build
    x, w, bias, nw, nb, s, k, p = layer
    B, T, C = x.shape
    dev = x.device
    code = _build.DTYPE_CODES[x.dtype]
    out_t = (T + 2 * p - k) // s + 1
    f32 = dict(dtype=torch.float32, device=dev)
    out = torch.empty((B, out_t, C), dtype=x.dtype, device=dev)
    yn = torch.empty((B, out_t, C), **f32)
    inv = torch.empty((B, out_t), **f32)
    fsc = _build.scratch(lib.cpc_conv_ln_fwd_scratch(B, T, C, s, p, code),
                         dev)
    dx = torch.empty_like(x)
    vout, dw = torch.empty((3, C), **f32), torch.empty((k * C, C), **f32)
    bsc = _build.scratch(lib.cpc_conv_ln_bwd_scratch(B, T, C, s, p, code),
                         dev)
    st = _build.stream(dev)

    def fwd():
        r = lib.cpc_conv_ln_fwd(x.data_ptr(), w.data_ptr(), bias.data_ptr(),
                                nw.data_ptr(), nb.data_ptr(), out.data_ptr(),
                                yn.data_ptr(), inv.data_ptr(),
                                _build.ptr(fsc), B, T, C, s, p, 1e-5, code,
                                st)
        assert r == 0, r
        return [out, yn, inv]

    def bwd():
        r = lib.cpc_conv_ln_bwd(x.data_ptr(), w.data_ptr(), nw.data_ptr(),
                                nb.data_ptr(), dy.data_ptr(), yn.data_ptr(),
                                inv.data_ptr(), dx.data_ptr(),
                                vout.data_ptr(), dw.data_ptr(),
                                _build.ptr(bsc), B, T, C, s, p, code, st)
        assert r == 0, r
        return [dx, vout, dw]
    fwd()
    return fwd, bwd


def main() -> None:
    sys.path.insert(0, HERE)
    import chip_smoke  # noqa: E402
    _ab.precision_policy()
    import torch
    edits = {n: {"conv_ln.cuh": v} if v else {} for n, v in VARIANTS.items()}
    libs = _ab.build_variants(os.path.join(HERE, "build", "k7_tiles"),
                              edits, SOURCES)
    dev = torch.device("cuda", 0)
    base = {}
    for name, (path, report) in libs.items():
        print(f"{name}: " + ", ".join(ptxas(report)), flush=True)
        lib = bind(path)
        for dtype in (torch.bfloat16, torch.float32):
            g = torch.Generator(device=dev).manual_seed(7)

            def rand(*shape, scale=1.0, dt=dtype):
                return (torch.randn(shape, generator=g, device=dev)
                        * scale).to(dt)
            layers, dys = chip_smoke.conv_layers(rand)
            pairs = [calls(lib, l, dy) for l, dy in zip(layers, dys)]
            f_ms = [chip_smoke.median_ms(f) for f, _ in pairs]
            b_ms = [chip_smoke.median_ms(b) for _, b in pairs]
            both = (chip_smoke.median_ms(lambda: [f() for f, _ in pairs]),
                    chip_smoke.median_ms(lambda: [b() for _, b in pairs]))
            digest = sha([t for f, b in pairs for t in f() + b()])
            key = str(dtype)[6:]
            same = base.setdefault(key, digest) == digest
            print(f"  {key}: layers 1-4 forward {both[0]:.4f} ms, backward "
                  f"{both[1]:.4f} ms; by layer, forward / backward: " +
                  ", ".join(f"{a:.4f} / {b:.4f}" for a, b in zip(f_ms, b_ms))
                  + f" ms; outputs {'as' if same else 'NOT as'} built",
                  flush=True)
            del layers, dys, pairs
            torch.cuda.empty_cache()
    print(chip_smoke.gpu_line(), flush=True)


if __name__ == "__main__":
    main()
