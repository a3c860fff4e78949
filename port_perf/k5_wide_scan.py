#!/usr/bin/env python3
"""K5 at head width 512 (--hiddenEncoder 4096) against its key tiles and
its blocks, beside SDPA, on one GPU.

Usage, from the root of a checkout:
    python3 port_perf/k5_wide_scan.py

Times K5's forward and backward (chip_smoke.median_ms, rate 0) at dk 512
for N rows of S in N 8, 32, 128 (B 1, 4, 16 x 8 heads: 64 to 1024
blocks of 16 query rows at S 128) and S 16, 32, 64, 128 (the longest
block walks S / 16 key tiles), in bf16 and float32, and SDPA's call on
the same inputs (its dense bias as a float mask), and prints each with
the time a key tile of the longest block, so that a walk bound by its
serial key tiles shows as a flat time in N and a line in S.
"""

from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    sys.path.insert(0, HERE)
    import torch
    import chip_smoke
    from cpc_audio_tpu_torch import _common
    from cpc_audio_tpu_torch.ops import causal_attention as ca
    _common.precision_policy()
    dev = torch.device("cuda", 0)
    dk = 512
    for dtype in (torch.bfloat16, torch.float32):
        for N in (8, 32, 128):
            for S in (16, 32, 64, 128):
                g = torch.Generator(device=dev).manual_seed(5)

                def rand(*shape, scale=1.0, grad=False):
                    t = (torch.randn(shape, generator=g, device=dev)
                         * scale).to(dtype)
                    return t.requires_grad_(grad)
                cases = chip_smoke.causal_cases(rand, None, N, S, dk,
                                                f"S {S}", rate=0.0)
                sdpa = chip_smoke.sdpa_calls(rand, N // 8, dk, S=S)
                ms = [chip_smoke.median_ms(c.kernel) for c in cases]
                lib = [chip_smoke.median_ms(f) for f in sdpa]
                tiles = -(-S // 16)
                print(f"{str(dtype)[6:]} N {N} S {S} dk {dk}: K5 forward "
                      f"{ms[0]:.4f} ms ({1e3 * ms[0] / tiles:.2f} us a key "
                      f"tile), backward {ms[1]:.4f} ms; SDPA {lib[0]:.4f} / "
                      f"{lib[1]:.4f} ms", flush=True)
                del cases, sdpa
    print(chip_smoke.gpu_line(), flush=True)


if __name__ == "__main__":
    main()
