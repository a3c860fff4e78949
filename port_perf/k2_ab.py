#!/usr/bin/env python3
"""K2's forward and backward of two checkouts, in turns, on one GPU.

Usage, from the root of a checkout:
    python3 port_perf/k2_ab.py OTHER_CHECKOUT

Runs this checkout's and OTHER_CHECKOUT's K2 (each built from its own
sources at first use, each in a process of its own) in the order other,
this, this, other, and prints, at every shape chip_smoke.py's train paths
give K2 (K 12 heads, 8 attention heads; B, S and dk of the default path,
the --sizeWindow 40960 --hiddenEncoder 512, 768, 200, 1056, --sizeWindow
163840, --hiddenEncoder 2048, 4096 and 4160 paths) and at chip_smoke's
S 3700, dk 264 and dk 520 cases (K 1, B 1, 2 heads; a call that takes
seconds is timed once after the two that hash it), in bf16 and float32
at dropout
rate 0.1 (the train step's), the device time a call
(chip_smoke.median_ms) of the forward and the backward, the body each ran
where the checkout has bodies, and a SHA-256 of each direction's outputs
(then whether reruns and the two checkouts agree bit for bit).  Both
checkouts run under this checkout's float32 precision policy (TF32 off).
"""

from __future__ import annotations

import json
import os
import sys
import time

import _ab
from _ab import HERE, sha
# (B, S, dk, path[, K, heads])
SHAPES = ((32, 116, 32, "default"), (8, 244, 64, "40960/512"),
          (32, 116, 96, "768"), (32, 116, 25, "200"),
          (32, 116, 132, "1056"), (4, 1012, 32, "163840"),
          (4, 116, 256, "2048"), (4, 116, 512, "4096"),
          (4, 116, 520, "4160"), (1, 3700, 264, "S 3700", 1, 2),
          (1, 3700, 520, "S 3700 dk 520", 1, 2))
K, NH, RATE = 12, 8, 0.1


def one(root: str) -> None:
    """Time the checkout at ``root`` and print one JSON line."""
    sys.path.insert(0, HERE)
    import chip_smoke  # noqa: E402
    _ab.precision_policy()
    sys.path.insert(0, root)
    import torch
    from cpc_audio_tpu_torch.ops import head_attention as ha
    if not os.path.abspath(ha.__file__).startswith(os.path.abspath(root)):
        raise SystemExit(f"imported {ha.__file__}, not {root}'s")
    dev = torch.device("cuda", 0)
    seed = torch.tensor([11], dtype=torch.int64, device=dev)
    out = {}
    for B, S, dk, path, *kh in SHAPES:
        k, nh = kh or (K, NH)
        for dtype in (torch.bfloat16, torch.float32):
            g = torch.Generator(device=dev).manual_seed(7)

            def rand(*shape, scale=1.0):
                return (torch.randn(shape, generator=g, device=dev)
                        * scale).to(dtype)
            M, D = B * S, nh * dk
            args = (rand(k, M, D), rand(k, M, D), rand(k, M, D),
                    rand(k, dk, S, scale=0.5))
            do = rand(k, M, D, scale=0.1)
            fwd = lambda: ha.relpos_attention_fwd(*args, B, nh, RATE,  # noqa
                                                  seed)
            bwd = lambda: ha.relpos_attention_bwd(*args, do, B, nh,    # noqa
                                                  RATE, seed)
            t0 = time.perf_counter()
            hashes = [(sha([fwd()]), sha(bwd())) for _ in range(2)]
            slow = dict(warmup=0, reps=1) \
                if time.perf_counter() - t0 > 2 else {}
            row = {"fwd_ms": chip_smoke.median_ms(fwd, **slow),
                   "bwd_ms": chip_smoke.median_ms(bwd, **slow),
                   "fwd_sha256": hashes[0][0], "bwd_sha256": hashes[0][1],
                   "rerun_same": hashes[0] == hashes[1]}
            if hasattr(ha, "fwd_body"):
                row["body"] = (ha.fwd_body(S, dk, dtype),
                               ha.bwd_body(S, dk, dtype))
            name = str(dtype).replace("torch.", "")
            out[f"{path}: B {B} S {S} dk {dk} {name}"] = row
            del args, do
            torch.cuda.empty_cache()
    print(json.dumps(out))


def report(who: str, root: str, res: dict) -> None:
    for case, t in res.items():
        body = f" (bodies {t['body'][0]} / {t['body'][1]})" \
            if "body" in t else ""
        print(f"{who} ({root}) {case}{body}: forward {t['fwd_ms']:.4f} ms "
              f"(sha256 {t['fwd_sha256']}), backward {t['bwd_ms']:.4f} ms "
              f"(sha256 {t['bwd_sha256']}); rerun bit-identical "
              f"{t['rerun_same']}", flush=True)


def main() -> None:
    _ab.main(__file__, one, report, ("fwd_sha256", "bwd_sha256"), __doc__)
    if len(sys.argv) == 2:      # the card the runs above took
        sys.path.insert(0, HERE)
        import chip_smoke  # noqa: E402
        print(chip_smoke.gpu_line(), flush=True)


if __name__ == "__main__":
    main()
