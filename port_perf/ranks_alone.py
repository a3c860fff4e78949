#!/usr/bin/env python3
"""chip_smoke.py's train CLI phase and its multi-rank phase alone, on one
GPU, with K8 at the global pool's shape.

Usage, from the root of a checkout:
    python3 port_perf/ranks_alone.py

Builds the kernels, holds K8 at the pool of two ranks (475,136 keys into
8192 rows, bf16) against its plain version and times it in turns with
``index_add_`` (chip_smoke.median_ms), then runs chip_smoke's
``phase_cli`` (whose tree and logs ``phase_ranks`` (a) reads) and
``phase_ranks``.  Any failure exits non-zero, as in chip_smoke.
"""

import os
import sys
import tempfile
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
import chip_smoke as cs  # noqa: E402


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    print(cs.gpu_line(), torch.__version__, torch.version.cuda, flush=True)
    from cpc_audio_tpu_torch import _common
    from cpc_audio_tpu_torch.ops import _build
    from cpc_audio_tpu_torch.ops import scatter_add as sa
    _common.precision_policy()
    t0 = time.time()
    _build.library()
    print(f"kernels built in {time.time() - t0:.1f} s", flush=True)
    dev = torch.device("cuda", 0)
    upd, keys, order, offsets, R = cs.scatter_inputs(dev, torch.bfloat16,
                                                     world=cs.RANKS)
    err = (sa.scatter_add_sorted(upd, order, offsets)
           - sa.scatter_add_rows_ref(upd, keys, R)).abs().max().item()
    print(f"K8 at R {R}: max |err| against its plain version {err:.3e}",
          flush=True)
    calls = {"K8": lambda: sa.scatter_add_sorted(upd, order, offsets),
             "index_add_": lambda: torch.zeros(
                 R, upd.shape[1], device=dev).index_add_(0, keys,
                                                         upd.float()),
             "plain": lambda: sa.scatter_add_rows_ref(upd, keys, R)}
    for who in ("K8", "index_add_", "index_add_", "K8", "plain"):
        print(f"  {who}: {cs.median_ms(calls[who]):.4f} ms", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        cs.phase_cli(tmp, dev)
        print(f"[phase train CLI {time.time() - t0:.1f} s]", flush=True)
        print(cs.phase_ranks(tmp, dev), flush=True)
    print(cs.gpu_line())


if __name__ == "__main__":
    main()
