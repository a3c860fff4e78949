#!/usr/bin/env python3
"""K1's and K4's forward and backward, some train steps and build_feature
of two checkouts, in turns, on one GPU.

Usage, from the root of a checkout:
    python3 port_perf/k1_ab.py OTHER_CHECKOUT

Runs this checkout's and OTHER_CHECKOUT's K1 (LSTM) and K4 (GRU) (each
built from its own sources at first use, each in a process of its own) in
the order other, this, this, other, and prints, in bf16 and float32, the
device time a call (chip_smoke.median_ms; fewer calls at H 4096) of the
forward (saving residuals, as training does) and the backward, with the
body each ran and a SHA-256 of each direction's outputs (then whether
reruns and the two checkouts agree bit for bit): K1 at B 32 / T 128 /
H 128 and 256, B 1 / T 400 / H 256 (build_feature's), B 8 / T 256 / H
512, B 32 / T 128 / H 512 and 768 (the cluster bodies), B 32 / T 128 / H
264, 384 and 1056 and B 4 / T 128 / H 4096; K4 at B 32 / T 128 / H 128,
256, 288, 384, 512 and 768, B 1 / T 400 / H 256 and B 4 / T 128 / H
4096 (just past 256, where the rows body costs least beside the grid
body, the times check where the grid body starts); at H <= 256 also
cuDNN's nn.LSTM / nn.GRU forward (training, input projection included)
in the same dtype, a yardstick the port never calls.  Then the train
steps of the default LSTM in bf16 and float32 (the CLIs' default), the
default GRU, the --hiddenEncoder 1056 --hiddenGar 1056 LSTM and the
--hiddenEncoder 512 --hiddenGar 512 GRU in bf16 (B 32, dropout 0.1):
train windows/s as the median of 10 synchronised steps after 2 warm-up;
and build_feature's latency on a 4 s file with the default LSTM in both
dtypes (chip_smoke.feature_latency).
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

import _ab
from _ab import HERE, sha
SHAPES = (("lstm", 32, 128, 128), ("lstm", 32, 128, 256),
          ("lstm", 1, 400, 256), ("lstm", 32, 128, 264),
          ("lstm", 32, 128, 384), ("lstm", 8, 256, 512),
          ("lstm", 32, 128, 512), ("lstm", 32, 128, 768),
          ("lstm", 32, 128, 1056), ("lstm", 4, 128, 4096),
          ("gru", 32, 128, 128), ("gru", 32, 128, 256),
          ("gru", 1, 400, 256), ("gru", 32, 128, 288),
          ("gru", 32, 128, 384), ("gru", 32, 128, 512),
          ("gru", 32, 128, 768), ("gru", 4, 128, 4096))
TRAIN_PATHS = (("LSTM", "bfloat16"), ("LSTM", "float32"),
               ("GRU", "bfloat16"), ("LSTM 1056", "bfloat16"),
               ("GRU 512", "bfloat16"))


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
            cudnn_ms = None
            if H <= 256:
                cudnn = chip_smoke.cudnn_layer(dev, dtype, kind, g, B=B, T=T,
                                               C=H)
                cudnn_ms = chip_smoke.median_ms(cudnn[0])
                del cudnn
            out[f"{kind} {str(dtype)[6:]} B {B} / T {T} / H {H}"] = {
                "cudnn_fwd_ms": cudnn_ms,
                "fwd_ms": chip_smoke.median_ms(fwd, **timing),
                "bwd_ms": chip_smoke.median_ms(bwd, **timing),
                "fwd_body": getattr(mod, "fwd_body", lambda *a: "rows")(
                    H, dtype),
                "bwd_body": mod.bwd_body(H, dtype),
                "fwd_sha256": hashes[0][0], "bwd_sha256": hashes[0][1],
                "rerun_same": hashes[0] == hashes[1]}
            del la, lba, ga, gba
            torch.cuda.empty_cache()
    for path, dt in TRAIN_PATHS:
        model, crit = chip_smoke.build(path, dt,
                                       torch.Generator().manual_seed(1))
        step, batch, key = chip_smoke.train_setup(model, crit, dev)
        times = []
        for i in range(12):
            t0 = time.perf_counter()
            step(batch, key=key)
            torch.cuda.synchronize()
            if i >= 2:
                times.append(time.perf_counter() - t0)
        out[f"{path} {dt}"] = {"windows_s": 32 / statistics.median(times),
                               "step_ms": statistics.median(times) * 1e3}
        del model, crit, step
        torch.cuda.empty_cache()
    for dt in ("bfloat16", "float32"):
        model, _ = chip_smoke.build("LSTM", dt,
                                    torch.Generator().manual_seed(1))
        feats, ms = chip_smoke.feature_latency(model.to(dev))
        out[f"build_feature {dt}"] = {"feature_ms": ms,
                                      "shape": list(feats.shape)}
        del model
        torch.cuda.empty_cache()
    print(json.dumps(out))


def report(who: str, root: str, res: dict) -> None:
    for shape, t in res.items():
        if "feature_ms" in t:
            print(f"{who} ({root}) {shape}: {t['feature_ms']:.3f} ms a 4 s "
                  f"file, features {t['shape']}", flush=True)
            continue
        if "windows_s" in t:
            print(f"{who} ({root}) {shape} train step: "
                  f"{t['windows_s']:.1f} windows/s ({t['step_ms']:.3f} ms)",
                  flush=True)
            continue
        print(f"{who} ({root}) {shape}: forward {t['fwd_ms']:.4f} ms "
              f"({t['fwd_body']} body, sha256 {t['fwd_sha256']}), "
              f"backward {t['bwd_ms']:.4f} ms ({t['bwd_body']} body, "
              f"sha256 {t['bwd_sha256']}); rerun bit-identical "
              f"{t['rerun_same']}"
              + (f"; cuDNN forward {t['cudnn_fwd_ms']:.4f} ms"
                 if t.get("cudnn_fwd_ms") is not None else ""), flush=True)


def main() -> None:
    _ab.main(__file__, one, report, ("fwd_sha256", "bwd_sha256"), __doc__)


if __name__ == "__main__":
    main()
