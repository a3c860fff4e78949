#!/usr/bin/env python3
"""K5's forward and backward of two checkouts, in turns, on one GPU.

Usage, from the root of a checkout:
    python3 port_perf/k5_ab.py OTHER_CHECKOUT

Runs this checkout's and OTHER_CHECKOUT's K5 (each built from its own
sources at first use, each in a process of its own) in the order other,
this, this, other, and prints, at N 256 (B 32 x 8 heads), S 128 and dk
32, 64 and 128 in bf16 and dk 32 and 64 in float32, and at N 32 (B 4 x 8
heads, the transformer's at --hiddenEncoder 2048 and 4096), S 128, dk 256
and 512 in both, at dropout rate 0
and 0.1, the device time a call (chip_smoke.median_ms) of the forward and
the backward, a SHA-256 of each direction's outputs (then whether reruns
and the two checkouts agree bit for bit), and in float32 the largest
error against the plain version in float64 (forward: max |err|;
backward: the largest 2-norm error of dq, dk, dv and dbias relative to
the gradient's norm).  Both checkouts run under this checkout's float32
precision policy (TF32 off).
"""

from __future__ import annotations

import json
import os
import sys

import _ab
from _ab import HERE, sha
CASES = (("bfloat16", 32), ("bfloat16", 64), ("bfloat16", 128),
         ("float32", 32), ("float32", 64), ("bfloat16", 256),
         ("float32", 256), ("bfloat16", 512), ("float32", 512))


def one(root: str) -> None:
    """Time the checkout at ``root`` and print one JSON line."""
    sys.path.insert(0, HERE)
    import chip_smoke  # noqa: E402
    _ab.precision_policy()
    sys.path.insert(0, root)
    import torch
    from cpc_audio_tpu_torch.ops import causal_attention as ca
    if not os.path.abspath(ca.__file__).startswith(os.path.abspath(root)):
        raise SystemExit(f"imported {ca.__file__}, not {root}'s")
    dev = torch.device("cuda", 0)
    seed = torch.tensor([11], dtype=torch.int64, device=dev)
    out = {}
    for dt, dk in CASES:
        dtype = getattr(torch, dt)
        g = torch.Generator(device=dev).manual_seed(7)
        N, S = (32 if dk >= 256 else 256), 128

        def rand(*shape, scale=1.0):
            return (torch.randn(shape, generator=g, device=dev)
                    * scale).to(dtype)
        args = (rand(N, S, dk), rand(N, S, dk), rand(N, S, dk),
                rand(N, S, S, scale=0.5))
        do = rand(N, S, dk, scale=0.1)
        for rate in (0.0, 0.1):
            fwd = lambda: ca.causal_attention_fwd(*args, rate, seed)  # noqa
            bwd = lambda: ca.causal_attention_bwd(*args, do, rate,    # noqa
                                                  seed)
            hashes = [(sha([fwd()]), sha(bwd())) for _ in range(2)]
            row = {"fwd_ms": chip_smoke.median_ms(fwd),
                   "bwd_ms": chip_smoke.median_ms(bwd),
                   "fwd_sha256": hashes[0][0], "bwd_sha256": hashes[0][1],
                   "rerun_same": hashes[0] == hashes[1]}
            if dtype == torch.float32:
                a64 = tuple(t.double() for t in args)
                want = ca.causal_attention_ref(*a64, rate, seed)
                row["fwd_err"] = (fwd().double() - want).abs().max().item()
                wants = ca.causal_attention_bwd_ref(*a64, do.double(), rate,
                                                    seed)
                row["bwd_rel"] = max(
                    ((a.double() - w).norm() / w.norm()).item()
                    for a, w in zip(bwd(), wants))
            out[f"{dt} dk {dk} rate {rate:g}"] = row
        del args, do
        torch.cuda.empty_cache()
    print(json.dumps(out))


def report(who: str, root: str, res: dict) -> None:
    for case, t in res.items():
        err = (f"; float64 error: forward {t['fwd_err']:.3e}, backward "
               f"{t['bwd_rel']:.3e} of the norm" if "fwd_err" in t else "")
        print(f"{who} ({root}) {case}: forward {t['fwd_ms']:.4f} ms "
              f"(sha256 {t['fwd_sha256']}), backward {t['bwd_ms']:.4f} "
              f"ms (sha256 {t['bwd_sha256']}); rerun bit-identical "
              f"{t['rerun_same']}{err}", flush=True)


def main() -> None:
    _ab.main(__file__, one, report, ("fwd_sha256", "bwd_sha256"), __doc__)


if __name__ == "__main__":
    main()
