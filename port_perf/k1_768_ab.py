#!/usr/bin/env python3
"""K1's forward at B 32 / T 128 and H 768 (both dtypes) and 512 (float32),
the 16-CTA cluster bodies whose W_hh partly streams from L2, of two
checkouts, in turns, on one GPU.

Usage, from the root of a checkout:
    python3 port_perf/k1_768_ab.py OTHER_CHECKOUT

Runs this checkout's and OTHER_CHECKOUT's K1 forward (saving residuals,
as training does; each tree built from its own sources at first use,
each in a process of its own) in the order other, this, this, other, and
prints the device time a call (chip_smoke.median_ms) and a SHA-256 of the
outputs, then whether reruns and the two checkouts agree bit for bit: a
short form of port_perf/k1_ab.py for the streamed layouts, e.g. against
a checkout from before csrc/rnn_cluster_fwd.cuh.
"""

from __future__ import annotations

import json
import os
import sys

import _ab
from _ab import HERE, sha

CASES = ((768, "float32"), (768, "bfloat16"), (512, "float32"))


def one(root: str) -> None:
    """Time the checkout at ``root`` and print one JSON line."""
    sys.path.insert(0, HERE)
    import chip_smoke  # noqa: E402
    sys.path.insert(0, root)
    import torch
    from cpc_audio_tpu_torch.ops import lstm
    if not os.path.abspath(lstm.__file__).startswith(os.path.abspath(root)):
        raise SystemExit(f"imported {lstm.__file__}, not {root}'s")
    _ab.precision_policy()
    dev = torch.device("cuda", 0)
    out = {}
    for H, dt in CASES:
        dtype = getattr(torch, dt)
        g = torch.Generator(device=dev).manual_seed(7)

        def rand(*shape, scale=1.0):
            return (torch.randn(shape, generator=g, device=dev)
                    * scale).to(dtype)
        args = chip_smoke.recurrent_args(rand, dev, 32, 128, H)[0]
        fwd = lambda: lstm.lstm_fwd(*args, save_residuals=True)  # noqa
        hashes = [sha(fwd()) for _ in range(2)]
        out[f"H {H} {dt}"] = {"fwd_ms": chip_smoke.median_ms(fwd),
                              "fwd_sha256": hashes[0],
                              "rerun_same": hashes[0] == hashes[1]}
    print(json.dumps(out))


def report(who: str, root: str, res: dict) -> None:
    for case, t in res.items():
        print(f"{who} ({root}) K1 forward, B 32 / T 128 / {case}: "
              f"{t['fwd_ms']:.4f} ms (sha256 {t['fwd_sha256']}); rerun "
              f"bit-identical {t['rerun_same']}", flush=True)


def main() -> None:
    _ab.main(__file__, one, report, ("fwd_sha256",), __doc__)


if __name__ == "__main__":
    main()
