#!/usr/bin/env python3
"""K1's and K4's forward and backward, and the LSTM 1056 and GRU 512
train steps, of two checkouts, in turns, on one GPU.

Usage, from the root of a checkout:
    python3 port_perf/k1_ab.py OTHER_CHECKOUT

Runs this checkout's and OTHER_CHECKOUT's K1 (LSTM) and K4 (GRU) (each
built from its own sources at first use, each in a process of its own) in
the order other, this, this, other, and prints, in bf16 and float32, the
device time a call (chip_smoke.median_ms; fewer calls at H 4096) of the
forward (saving residuals, as training does) and the backward, with the
body each ran and a SHA-256 of each direction's outputs (then whether
reruns and the two checkouts agree bit for bit): K1 at B 32 / T 128 /
H 256, B 8 / T 256 / H 512, B 32 / T 128 / H 512 and 768 (the rows and
cluster bodies), B 32 / T 128 / H 264, 384 and 1056 and B 4 / T 128 /
H 4096; K4 at B 32 / T 128 / H 256, 288, 384, 512 and 768 and B 4 /
T 128 / H 4096 (just past 256, where the rows body costs least beside
the grid body, the times check where the grid body starts).  Then the
bf16 train steps of the --hiddenEncoder 1056 --hiddenGar 1056 LSTM path
and the --hiddenEncoder 512 --hiddenGar 512 GRU path (B 32, dropout
0.1): train windows/s as the median of 10 synchronised steps after 2
warm-up.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

import _ab
from _ab import HERE, sha
SHAPES = (("lstm", 32, 128, 256), ("lstm", 32, 128, 264),
          ("lstm", 32, 128, 384), ("lstm", 8, 256, 512),
          ("lstm", 32, 128, 512), ("lstm", 32, 128, 768),
          ("lstm", 32, 128, 1056), ("lstm", 4, 128, 4096),
          ("gru", 32, 128, 256), ("gru", 32, 128, 288),
          ("gru", 32, 128, 384), ("gru", 32, 128, 512),
          ("gru", 32, 128, 768), ("gru", 4, 128, 4096))
TRAIN_PATHS = ("LSTM 1056", "GRU 512")


def one(root: str) -> None:
    """Time the checkout at ``root`` and print one JSON line."""
    sys.path.insert(0, HERE)
    import chip_smoke  # noqa: E402
    sys.path.insert(0, root)
    import torch
    from cpc_audio_tpu_torch.ops import gru, lstm
    if not os.path.abspath(lstm.__file__).startswith(os.path.abspath(root)):
        raise SystemExit(f"imported {lstm.__file__}, not {root}'s")
    _ab.precision_policy()
    dev = torch.device("cuda", 0)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        for kind, B, T, H in SHAPES:
            g = torch.Generator(device=dev).manual_seed(7)

            def rand(*shape, scale=1.0, dt=dtype):
                return (torch.randn(shape, generator=g, device=dev)
                        * scale).to(dt)
            la, lba, ga, gba = chip_smoke.recurrent_args(rand, dev, B, T, H)
            if kind == "lstm":
                mod = lstm
                fwd = lambda: lstm.lstm_fwd(*la, save_residuals=True)  # noqa
                bwd = lambda: lstm.lstm_bwd(*lba)                      # noqa
            else:
                mod = gru
                fwd = lambda: gru.gru_fwd(*ga, save_residuals=True)    # noqa
                bwd = lambda: gru.gru_bwd(*gba)                        # noqa
            hashes = [(sha(fwd()), sha(bwd())) for _ in range(2)]
            timing = dict(warmup=1, reps=2) if H >= 4096 else {}
            out[f"{kind} {str(dtype)[6:]} B {B} / T {T} / H {H}"] = {
                "fwd_ms": chip_smoke.median_ms(fwd, **timing),
                "bwd_ms": chip_smoke.median_ms(bwd, **timing),
                "fwd_body": getattr(mod, "fwd_body", lambda *a: "rows")(
                    H, dtype),
                "bwd_body": mod.bwd_body(H, dtype),
                "fwd_sha256": hashes[0][0], "bwd_sha256": hashes[0][1],
                "rerun_same": hashes[0] == hashes[1]}
            del la, lba, ga, gba
            torch.cuda.empty_cache()
    for path in TRAIN_PATHS:
        model, crit = chip_smoke.build(path, "bfloat16",
                                       torch.Generator().manual_seed(1))
        step, batch, key = chip_smoke.train_setup(model, crit, dev)
        times = []
        for i in range(12):
            t0 = time.perf_counter()
            step(batch, key=key)
            torch.cuda.synchronize()
            if i >= 2:
                times.append(time.perf_counter() - t0)
        out[path] = {"windows_s": 32 / statistics.median(times),
                     "step_ms": statistics.median(times) * 1e3}
        del model, crit, step
        torch.cuda.empty_cache()
    print(json.dumps(out))


def report(who: str, root: str, res: dict) -> None:
    for shape, t in res.items():
        if "windows_s" in t:
            print(f"{who} ({root}) {shape} train step: "
                  f"{t['windows_s']:.1f} windows/s ({t['step_ms']:.3f} ms)",
                  flush=True)
            continue
        print(f"{who} ({root}) {shape}: forward {t['fwd_ms']:.4f} ms "
              f"({t['fwd_body']} body, sha256 {t['fwd_sha256']}), "
              f"backward {t['bwd_ms']:.4f} ms ({t['bwd_body']} body, "
              f"sha256 {t['bwd_sha256']}); rerun bit-identical "
              f"{t['rerun_same']}", flush=True)


def main() -> None:
    _ab.main(__file__, one, report, ("fwd_sha256", "bwd_sha256"), __doc__)


if __name__ == "__main__":
    main()
