#!/usr/bin/env python3
"""K2's calls by kernel, in one checkout, on one GPU.

Usage, from the root of a checkout:
    python3 port_perf/k2_parts.py [ROOT] [--only PATH ...]

At every shape chip_smoke.py's train paths give K2 (as port_perf/k2_ab.py:
K 12 heads, 8 attention heads, but at its S 3700 cases; dropout rate
0.1), or at those of the named paths (k2_ab.SHAPES' path names, e.g.
4160), in bf16 and float32,
prints the device time a call of the forward and the backward
(chip_smoke.median_ms) and, from torch.profiler over three calls of each,
the device ms a call of each kernel they launch: the forward, the
backward's row, column and diagonal passes and its sum of the windows,
and the copies of krel and of the operands both directions make; last,
the card's name and power limit (nvidia-smi).  ROOT
(default: this checkout) is the checkout whose package is timed, under
this checkout's float32 precision policy (TF32 off).
"""

from __future__ import annotations

import os
import sys

import _ab
from _ab import HERE
from k2_ab import K, NH, RATE, SHAPES

PARTS = ("relpos_tc_fwd", "relpos_tc_bwd_rows", "relpos_tc_bwd_cols",
         "relpos_tc_bwd_diag", "dkrel_windows_reduce", "krel_planes",
         "head_planes")


def main() -> None:
    args = sys.argv[1:]
    only = args[args.index("--only") + 1:] if "--only" in args else None
    args = args[:args.index("--only")] if only is not None else args
    root = os.path.abspath(args[0]) if args else HERE
    sys.path.insert(0, HERE)
    import chip_smoke  # noqa: E402
    _ab.precision_policy()
    sys.path.insert(0, root)
    import torch
    from torch.profiler import ProfilerActivity, profile
    from cpc_audio_tpu_torch.ops import head_attention as ha
    if not os.path.abspath(ha.__file__).startswith(root):
        raise SystemExit(f"imported {ha.__file__}, not {root}'s")
    dev = torch.device("cuda", 0)
    seed = torch.tensor([11], dtype=torch.int64, device=dev)
    for B, S, dk, path, *kh in SHAPES:
        if only is not None and path not in only:
            continue
        k, nh = kh or (K, NH)
        for dtype in (torch.bfloat16, torch.float32):
            g = torch.Generator(device=dev).manual_seed(7)

            def rand(*shape, scale=1.0):
                return (torch.randn(shape, generator=g, device=dev)
                        * scale).to(dtype)
            M, D = B * S, nh * dk
            ops = (rand(k, M, D), rand(k, M, D), rand(k, M, D),
                   rand(k, dk, S, scale=0.5))
            do = rand(k, M, D, scale=0.1)
            fwd = lambda: ha.relpos_attention_fwd(*ops, B, nh, RATE,   # noqa
                                                  seed)
            bwd = lambda: ha.relpos_attention_bwd(*ops, do, B, nh,     # noqa
                                                  RATE, seed)
            f_ms, b_ms = chip_smoke.median_ms(fwd), chip_smoke.median_ms(bwd)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    fwd()
                    bwd()
                torch.cuda.synchronize()
            parts = {}
            for ev in prof.key_averages():
                t = getattr(ev, "device_time_total", 0)
                name = next((p for p in PARTS if p in ev.key), ev.key[:40])
                if t:
                    parts[name] = parts.get(name, 0.0) + t / 3 / 1000
            name = str(dtype).replace("torch.", "")
            print(f"{path}: B {B} S {S} dk {dk} {name}: forward {f_ms:.4f} "
                  f"ms, backward {b_ms:.4f} ms a call; by kernel, ms a "
                  f"call of each: " + ", ".join(
                      f"{p} {t:.4f}" for p, t in sorted(
                          parts.items(), key=lambda kv: -kv[1])),
                  flush=True)
            del ops, do
            torch.cuda.empty_cache()
    print(chip_smoke.gpu_line(), flush=True)


if __name__ == "__main__":
    main()
