#!/usr/bin/env python3
"""K3's forward and backward and the float32 default LSTM train step of
two checkouts, in turns, on one GPU.

Usage, from the root of a checkout:
    python3 port_perf/k3_ab.py OTHER_CHECKOUT

Runs this checkout's and OTHER_CHECKOUT's code (each built from its own
sources at first use, each in a process of its own) in the order other,
this, this, other.  Each run prints, for K3's forward and backward at
rate 0.1 on K 12 heads (M 3712 / D 256, M 1952 / D 512, M 3712 / D 768;
F 2048) in bf16 and float32: the device time a call
(chip_smoke.median_ms), a SHA-256 of each output's bytes (then whether
reruns and the two checkouts agree bit for bit), and, in float32, the
forward's largest error against the exact plain version (in float64:
`exact_forward`) with its share of the largest exact output, and each
gradient's 2-norm error relative to the exact plain backward
(ffn.layer_tail_bwd_ref in float64); then the default LSTM train step in
float32 (B 32, dropout 0.1): train windows/s as the median of 10
synchronised steps after 2 warm-up.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

import _ab
from _ab import HERE
SHAPES = ((3712, 256), (1952, 512), (3712, 768))
NAMES = ("dx", "dln1w", "dln1b", "dw1", "db1", "dw2", "db2", "dln2w",
         "dln2b")


def tail_inputs(dev, dtype, M: int, D: int, K: int = 12, F: int = 2048):
    """chip_smoke.py's K3 inputs at (K, M, D, F), from a fixed seed."""
    import torch
    g = torch.Generator(device=dev).manual_seed(11)

    def rand(*shape, scale=1.0, dt=dtype):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dt)
    f32 = torch.float32
    args = (rand(K, M, D), rand(K, D, scale=0.1, dt=f32) + 1,
            rand(K, D, scale=0.1, dt=f32), rand(K, D, F, scale=D ** -0.5),
            rand(K, F, scale=0.1, dt=f32), rand(K, F, D, scale=F ** -0.5),
            rand(K, D, scale=0.1, dt=f32),
            rand(K, D, scale=0.1, dt=f32) + 1, rand(K, D, scale=0.1, dt=f32))
    return args, rand(K, M, D, scale=0.1)


def exact_forward(ffn, args, rate: float, seed):
    """ffn.layer_tail_ref's math in float64 throughout (an older
    checkout's layer_tail_ref takes its products in float32 even for
    float64 inputs)."""
    import torch
    x, ln1w, ln1b, w1, b1, w2, b2, ln2w, ln2b = (a.double() for a in args)
    K, M, _ = x.shape
    y = ffn._affine(ffn._ln(x, 1e-5)[0], ln1w, ln1b)
    h = torch.relu(y @ w1 + b1[:, None])
    mask = ffn.dropout.ffn_mask(seed, rate, K, M, w1.shape[-1], x.device)
    if mask is not None:
        h = h * mask
    return ffn._affine(ffn._ln(y + h @ w2 + b2[:, None], 1e-5)[0], ln2w,
                       ln2b)


def sha(tensors) -> list:
    """A digest of each tensor's bytes (_ab.sha)."""
    return [_ab.sha([t]) for t in tensors]


def one(root: str) -> None:
    """Measure the checkout at ``root`` and print one JSON line."""
    sys.path.insert(0, HERE)
    from chip_smoke import SEED, build, median_ms, train_setup  # noqa: E402
    sys.path.insert(0, root)
    import torch
    from cpc_audio_tpu_torch.ops import ffn
    if not os.path.abspath(ffn.__file__).startswith(os.path.abspath(root)):
        raise SystemExit(f"imported {ffn.__file__}, not {root}'s")
    _ab.precision_policy()
    dev = torch.device("cuda", 0)
    seed = torch.tensor([SEED], dtype=torch.int64, device=dev)
    out = {}
    for M, D in SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            args, dout = tail_inputs(dev, dtype, M, D)
            fwd = ffn.layer_tail_fwd(*args, 0.1, 1e-5, seed)
            torch.cuda.synchronize()
            r = {"fwd_ms": median_ms(lambda: ffn.layer_tail_fwd(
                     *args, 0.1, 1e-5, seed)),
                 "fwd_sha256": sha([fwd])}
            if dtype == torch.float32:
                want = exact_forward(ffn, args, 0.1, seed)
                err = (fwd.double() - want).abs().max().item()
                r["fwd_err"] = (err, err / want.abs().max().item())
                del want
            del fwd
            got = ffn.layer_tail_bwd(*args, dout, 0.1, 1e-5, seed)
            torch.cuda.synchronize()
            r["ms"] = median_ms(lambda: ffn.layer_tail_bwd(
                *args, dout, 0.1, 1e-5, seed))
            r["sha256"] = sha(got)
            if dtype == torch.float32:
                exact = ffn.layer_tail_bwd_ref(
                    *[a.double() for a in args], dout.double(), 1e-5, 0.1,
                    seed)
                r["rel_err"] = [((g.double() - w).norm() / w.norm()).item()
                                for g, w in zip(got, exact)]
                del exact
            out[f"{str(dtype)[6:]} M {M} / D {D}"] = r
            del got, args, dout
            torch.cuda.empty_cache()
    model, crit = build("LSTM", "float32",
                        torch.Generator().manual_seed(SEED))
    step, batch, key = train_setup(model, crit, dev, 32)
    times = []
    for i in range(12):
        t0 = time.perf_counter()
        step(batch, key=key)
        torch.cuda.synchronize()
        if i >= 2:
            times.append(time.perf_counter() - t0)
    ms = statistics.median(times) * 1e3
    out["train"] = {"step_ms": ms, "windows_s": 32 / ms * 1e3,
                    "min_ms": min(times) * 1e3, "max_ms": max(times) * 1e3}
    print(json.dumps(out))


def report(who: str, root: str, res: dict) -> None:
    for case, t in res.items():
        if case == "train":
            print(f"{who}: float32 LSTM train step, B 32: "
                  f"{t['windows_s']:.1f} windows/s (median "
                  f"{t['step_ms']:.3f} ms of 10, min {t['min_ms']:.3f} "
                  f"max {t['max_ms']:.3f})", flush=True)
            continue
        err = (f"; max |err| vs exact {t['fwd_err'][0]:.3e} "
               f"({t['fwd_err'][1]:.3e} of max |want|)"
               if "fwd_err" in t else "")
        print(f"{who}: K3 forward {case}: {t['fwd_ms']:.4f} ms{err}",
              flush=True)
        err = ("; rel. 2-norm error vs exact: " + ", ".join(
            f"{n} {e:.2e}" for n, e in zip(NAMES, t["rel_err"]))
            if "rel_err" in t else "")
        print(f"{who}: K3 backward {case}: {t['ms']:.4f} ms{err}",
              flush=True)


def main() -> None:
    _ab.main(__file__, one, report, ("fwd_sha256", "sha256"), __doc__)


if __name__ == "__main__":
    main()
