#!/usr/bin/env python3
"""K4's forward at the widths of its resident body, of two checkouts, in
turns, on one GPU, beside cuDNN's GRU.

Usage, from the root of a checkout:
    python3 port_perf/k4_resident_ab.py OTHER_CHECKOUT

Runs this checkout's and OTHER_CHECKOUT's K4 forward (each built from its
own sources at first use, each in a process of its own) in the order
other, this, this, other, and prints, in bf16 and float32, the device time
a call (chip_smoke.median_ms) of the forward saving its residuals (as
training does) and without them (the eval path), the body it ran and a
SHA-256 of its outputs (then whether reruns and the two checkouts agree bit
for bit), at the learning gate's B 8 / T 32 / H 64 (eval/learning_gate.py,
540 calls in its 10 CPC epochs), at H 32, 96 and 160 beside it and at
B 32 / T 128 / H 64 and 160; beside each, cuDNN's nn.GRU forward
(training, input projection included) in the same dtype, timed in the
same process: a yardstick the port never calls.
"""

from __future__ import annotations

import json
import os
import sys

import _ab
from _ab import HERE, sha
# (B, T, H)
SHAPES = ((8, 32, 64), (8, 32, 32), (8, 32, 96), (8, 32, 160),
          (32, 128, 64), (32, 128, 160))


def one(root: str) -> None:
    """Time the checkout at ``root`` and print one JSON line."""
    sys.path.insert(0, HERE)
    import chip_smoke  # noqa: E402
    sys.path.insert(0, root)
    import torch
    from cpc_audio_tpu_torch.ops import gru
    if not os.path.abspath(gru.__file__).startswith(os.path.abspath(root)):
        raise SystemExit(f"imported {gru.__file__}, not {root}'s")
    _ab.precision_policy()
    dev = torch.device("cuda", 0)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        for B, T, H in SHAPES:
            g = torch.Generator(device=dev).manual_seed(7)

            def rand(*shape, scale=1.0):
                return (torch.randn(shape, generator=g, device=dev)
                        * scale).to(dtype)
            args = (rand(B, T, 3 * H), rand(3 * H, H, scale=H ** -0.5),
                    rand(3 * H, scale=0.1), rand(B, H, scale=0.5))
            train = lambda: gru.gru_fwd(*args, save_residuals=True)  # noqa
            infer = lambda: gru.gru_fwd(*args)                       # noqa
            hashes = [sha(train()) for _ in range(2)]
            cudnn = chip_smoke.cudnn_layer(dev, dtype, "gru", g, B=B, T=T,
                                           C=H)
            out[f"{str(dtype)[6:]} B {B} / T {T} / H {H}"] = {
                "fwd_ms": chip_smoke.median_ms(train),
                "eval_ms": chip_smoke.median_ms(infer),
                "cudnn_fwd_ms": chip_smoke.median_ms(cudnn[0]),
                "fwd_body": gru.fwd_body(H, dtype),
                "fwd_sha256": hashes[0], "rerun_same": hashes[0] == hashes[1]}
            del args, cudnn
            torch.cuda.empty_cache()
    print(json.dumps(out))


def report(who: str, root: str, res: dict) -> None:
    for shape, t in res.items():
        print(f"{who} ({root}) {shape} ({t['fwd_body']} body): forward "
              f"{t['fwd_ms']:.4f} ms, without residuals {t['eval_ms']:.4f}"
              f" (sha256 {t['fwd_sha256']}; rerun bit-identical "
              f"{t['rerun_same']}), cuDNN's GRU {t['cudnn_fwd_ms']:.4f} ms, "
              f"{t['fwd_ms'] / t['cudnn_fwd_ms']:.3f}x", flush=True)


def main() -> None:
    _ab.main(__file__, one, report, ("fwd_sha256",), __doc__)
    if len(sys.argv) == 2:      # the card the runs above took
        sys.path.insert(0, HERE)
        import chip_smoke  # noqa: E402
        print(chip_smoke.gpu_line(), flush=True)


if __name__ == "__main__":
    main()
