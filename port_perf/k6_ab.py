#!/usr/bin/env python3
"""K6's forward and backward of two checkouts, in turns, on one GPU, beside
the unfused composition the heads run by default.

Usage, from the root of a checkout:
    python3 port_perf/k6_ab.py OTHER_CHECKOUT

Runs this checkout's and OTHER_CHECKOUT's K6 (each built from its own
sources at first use, each in a process of its own) in the order other,
this, this, other, and prints, at the default train shape (K 12 heads, B
32, S 116, 8 heads x dk 32) and at the card tests' S 20 / dk 16, in bf16
and float32 at dropout rate 0.1 (the train step's), the device time a
call (chip_smoke.median_ms) of the forward and the backward (from the
forward's residuals where the checkout's backward takes them), a SHA-256
of each direction's outputs (then whether reruns and the two checkouts
agree bit for bit), and in each run the unfused composition
(chip_smoke.block_composition: cuBLAS projections + K2 + cuBLAS Wo +
residual, autograd backward) on the same inputs.  Both checkouts run under
this checkout's float32 precision policy (TF32 off).
"""

from __future__ import annotations

import inspect
import json
import os
import sys

import _ab
from _ab import HERE, sha
# (K, B, S, nheads, dk)
SHAPES = ((12, 32, 116, 8, 32), (12, 32, 20, 4, 16))
RATE = 0.1


def one(root: str) -> None:
    """Time the checkout at ``root`` and print one JSON line."""
    sys.path.insert(0, HERE)
    import chip_smoke  # noqa: E402
    _ab.precision_policy()
    sys.path.insert(0, root)
    import torch
    from cpc_audio_tpu_torch.ops import attention_block as ab
    if not os.path.abspath(ab.__file__).startswith(os.path.abspath(root)):
        raise SystemExit(f"imported {ab.__file__}, not {root}'s")
    # since the saved residuals: the forward returns (x, saved), the
    # backward reads saved
    saves = "saved" in inspect.signature(ab.attention_block_bwd).parameters
    dev = torch.device("cuda", 0)
    seed = torch.tensor([11], dtype=torch.int64, device=dev)
    out = {}
    for K, B, S, nh, dk in SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            g = torch.Generator(device=dev).manual_seed(7)

            def rand(*shape, scale=1.0):
                return (torch.randn(shape, generator=g, device=dev)
                        * scale).to(dtype)
            M, D = B * S, nh * dk
            args = (rand(M, D),) + tuple(rand(K, D, D, scale=D ** -0.5)
                                         for _ in range(4)) \
                + (rand(K, dk, S, scale=0.5),)
            do = rand(K, M, D, scale=0.1)
            if saves:
                saved = ab.attention_block_fwd(*args, B, nh, RATE, seed)[1]
                fwd = lambda: ab.attention_block_fwd(   # noqa: E731
                    *args, B, nh, RATE, seed)[0]
                bwd = lambda: ab.attention_block_bwd(   # noqa: E731
                    *args, do, saved, B, nh, RATE, seed)
            else:
                saved = None
                fwd = lambda: ab.attention_block_fwd(   # noqa: E731
                    *args, B, nh, RATE, seed)
                bwd = lambda: ab.attention_block_bwd(   # noqa: E731
                    *args, do, B, nh, RATE, seed)
            hashes = [(sha([fwd()]), sha(bwd())) for _ in range(2)]
            comp = chip_smoke.block_composition(args, do, B, nh, RATE, seed)
            row = {"fwd_ms": chip_smoke.median_ms(fwd),
                   "bwd_ms": chip_smoke.median_ms(bwd),
                   "comp_fwd_ms": chip_smoke.median_ms(comp[0]),
                   "comp_bwd_ms": chip_smoke.median_ms(comp[1]),
                   "fwd_sha256": hashes[0][0], "bwd_sha256": hashes[0][1],
                   "rerun_same": hashes[0] == hashes[1]}
            name = str(dtype).replace("torch.", "")
            out[f"K {K} B {B} S {S} {nh} x {dk} {name}"] = row
            del args, do, saved, comp
            torch.cuda.empty_cache()
    print(json.dumps(out))


def report(who: str, root: str, res: dict) -> None:
    for case, t in res.items():
        print(f"{who} ({root}) {case}: forward {t['fwd_ms']:.4f} ms "
              f"(sha256 {t['fwd_sha256']}), backward {t['bwd_ms']:.4f} ms "
              f"(sha256 {t['bwd_sha256']}); rerun bit-identical "
              f"{t['rerun_same']}; composition forward "
              f"{t['comp_fwd_ms']:.4f} ms, backward {t['comp_bwd_ms']:.4f} "
              f"ms", flush=True)


def main() -> None:
    _ab.main(__file__, one, report, ("fwd_sha256", "bwd_sha256"), __doc__)
    if len(sys.argv) == 2:      # the card the runs above took
        sys.path.insert(0, HERE)
        import chip_smoke  # noqa: E402
        print(chip_smoke.gpu_line(), flush=True)


if __name__ == "__main__":
    main()
