#!/usr/bin/env python3
"""K1's bf16 forward and backward of two checkouts, in turns, on one GPU.

Usage, from the root of a checkout:
    python3 port_perf/k1_ab.py OTHER_CHECKOUT

Runs this checkout's and OTHER_CHECKOUT's K1 (each built from its own
sources at first use, each in a process of its own) in the order other,
this, this, other, and prints the device time a call (chip_smoke.median_ms)
of the forward (saving residuals, as training does) and the backward at B 8
/ T 256 / H 512, B 32 / T 128 / H 512 and B 32 / T 128 / H 768, with the
body each ran.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((8, 256, 512), (32, 128, 512), (32, 128, 768))


def one(root: str) -> None:
    """Time the checkout at ``root`` and print one JSON line."""
    sys.path.insert(0, HERE)
    from chip_smoke import median_ms, recurrent_args  # noqa: E402
    sys.path.insert(0, root)
    import torch
    from cpc_audio_tpu_torch.ops import lstm
    if not os.path.abspath(lstm.__file__).startswith(os.path.abspath(root)):
        raise SystemExit(f"imported {lstm.__file__}, not {root}'s")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(7)

    def rand(*shape, scale=1.0, dt=torch.bfloat16):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dt)
    out = {}
    for B, T, H in SHAPES:
        fa, ba = recurrent_args(rand, dev, B, T, H)[:2]
        bodies = {n: getattr(lstm, n)(H, torch.bfloat16)
                  for n in ("fwd_body", "bwd_body") if hasattr(lstm, n)}
        out[f"B {B} / T {T} / H {H}"] = {
            "fwd_ms": median_ms(lambda: lstm.lstm_fwd(*fa,
                                                      save_residuals=True)),
            "bwd_ms": median_ms(lambda: lstm.lstm_bwd(*ba)),
            "fwd_body": bodies.get("fwd_body", "rows"),
            "bwd_body": bodies.get("bwd_body")}
    print(json.dumps(out))


def main() -> None:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        one(sys.argv[2])
        return
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    other = os.path.abspath(sys.argv[1])
    for who, root in (("other", other), ("this", HERE), ("this", HERE),
                      ("other", other)):
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--one", root], capture_output=True, text=True)
        if r.returncode != 0:
            raise SystemExit(f"{root}: failed\n{r.stderr[-3000:]}")
        res = json.loads(r.stdout.strip().splitlines()[-1])
        for shape, t in res.items():
            print(f"{who} ({root}) {shape}: forward {t['fwd_ms']:.4f} ms "
                  f"({t['fwd_body']} body), backward {t['bwd_ms']:.4f} ms "
                  f"({t['bwd_body']} body)", flush=True)


if __name__ == "__main__":
    main()
