#!/usr/bin/env python3
"""K7's forward and backward of two checkouts, in turns, on one GPU, beside
the unfused composition the encoder runs by default.

Usage, from the root of a checkout:
    python3 port_perf/k7_ab.py OTHER_CHECKOUT

Runs this checkout's and OTHER_CHECKOUT's K7 (each built from its own
sources at first use, each in a process of its own) in the order other,
this, this, other, and prints, at the default train shapes (encoder
layers 1-4 at B 32, C 256: 1024, 512, 256 and 128 frames;
chip_smoke.conv_layers), in bf16 and float32, the device time a call
(chip_smoke.median_ms) of the forward and the backward over the four
layers (the backward from the forward's residuals where the checkout's
backward takes them) and of each layer alone, a SHA-256 of each
direction's outputs (then whether reruns and the two checkouts agree bit
for bit), and in each run the unfused composition
(chip_smoke.conv_composition: cuDNN conv + ChannelNorm + ReLU, autograd
backward with dW) on the same inputs.  Both checkouts run under this
checkout's float32 precision policy (TF32 off).
"""

from __future__ import annotations

import inspect
import json
import os
import sys

import _ab
from _ab import HERE, sha


def one(root: str) -> None:
    """Time the checkout at ``root`` and print one JSON line."""
    sys.path.insert(0, HERE)
    import chip_smoke  # noqa: E402
    _ab.precision_policy()
    sys.path.insert(0, root)
    import torch
    from cpc_audio_tpu_torch.ops import conv_ln as cl
    if not os.path.abspath(cl.__file__).startswith(os.path.abspath(root)):
        raise SystemExit(f"imported {cl.__file__}, not {root}'s")
    # since the saved residuals: the forward returns (out, saved), the
    # backward reads saved
    saves = "saved" in inspect.signature(cl.conv_ln_relu_bwd).parameters
    dev = torch.device("cuda", 0)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        g = torch.Generator(device=dev).manual_seed(7)

        def rand(*shape, scale=1.0, dt=dtype):
            return (torch.randn(shape, generator=g, device=dev)
                    * scale).to(dt)
        layers, dys = chip_smoke.conv_layers(rand)
        if saves:
            saved = [cl.conv_ln_relu_fwd(*l)[1] for l in layers]
            fwds = [lambda l=l: cl.conv_ln_relu_fwd(*l)[0] for l in layers]
            bwds = [lambda l=l, dy=dy, sv=sv: cl.conv_ln_relu_bwd(
                *l[:5], dy, sv, *l[5:])
                for l, dy, sv in zip(layers, dys, saved)]
        else:
            saved = None
            fwds = [lambda l=l: cl.conv_ln_relu_fwd(*l) for l in layers]
            bwds = [lambda l=l, dy=dy: cl.conv_ln_relu_bwd(*l[:5], dy,
                                                           *l[5:])
                    for l, dy in zip(layers, dys)]

        def fwd():
            return [f() for f in fwds]

        def bwd():
            return [t for b in bwds for t in b()]
        hashes = [(sha(fwd()), sha(bwd())) for _ in range(2)]
        comp = chip_smoke.conv_composition(layers, dys)
        row = {"fwd_ms": chip_smoke.median_ms(fwd),
               "bwd_ms": chip_smoke.median_ms(bwd),
               "layers_fwd_ms": [chip_smoke.median_ms(f) for f in fwds],
               "layers_bwd_ms": [chip_smoke.median_ms(b) for b in bwds],
               "comp_fwd_ms": chip_smoke.median_ms(comp[0]),
               "comp_bwd_ms": chip_smoke.median_ms(comp[1]),
               "fwd_sha256": hashes[0][0], "bwd_sha256": hashes[0][1],
               "rerun_same": hashes[0] == hashes[1]}
        out[f"layers 1-4 B 32 {str(dtype).replace('torch.', '')}"] = row
        del layers, dys, saved, fwds, bwds, comp
        torch.cuda.empty_cache()
    print(json.dumps(out))


def report(who: str, root: str, res: dict) -> None:
    for case, t in res.items():
        per = ", ".join(f"{f:.4f} / {b:.4f}" for f, b in
                        zip(t["layers_fwd_ms"], t["layers_bwd_ms"]))
        print(f"{who} ({root}) {case}: forward {t['fwd_ms']:.4f} ms "
              f"(sha256 {t['fwd_sha256']}), backward {t['bwd_ms']:.4f} ms "
              f"(sha256 {t['bwd_sha256']}); rerun bit-identical "
              f"{t['rerun_same']}; by layer, forward / backward: {per} ms; "
              f"composition forward {t['comp_fwd_ms']:.4f} ms, backward "
              f"{t['comp_bwd_ms']:.4f} ms", flush=True)


def main() -> None:
    _ab.main(__file__, one, report, ("fwd_sha256", "bwd_sha256"), __doc__)
    if len(sys.argv) == 2:      # the card the runs above took
        sys.path.insert(0, HERE)
        import chip_smoke  # noqa: E402
        print(chip_smoke.gpu_line(), flush=True)


if __name__ == "__main__":
    main()
