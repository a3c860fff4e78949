#!/usr/bin/env python3
"""Train steps of two checkouts, in turns, on one GPU: the default LSTM,
GRU and transformer in bf16, the fused-layer LSTM (CPC_ATTN_BLOCK=1
CPC_PALLAS_CONV=1: K6 in the heads, K7 in encoder layers 1-4) in bf16 and
float32, and the default LSTM in float32 (the CLIs' default dtype).

Usage, from the root of a checkout:
    python3 port_perf/train_step_ab.py OTHER_CHECKOUT [wide]

With ``wide``, the transformer at --hiddenEncoder 4096 --hiddenGar 4096
in bf16 and float32 and the LSTM at --hiddenEncoder 4160 --hiddenGar 4160
in bf16 instead (chip_smoke's long and wide paths' B 4: the AR's K5 and
the heads' K2 at dk 512, the heads' K2 at dk 520 past it).

Runs this checkout's and OTHER_CHECKOUT's steps (each built from its own
sources at first use, each checkout's steps in a process of their own) in
the order other, this, this, other, at the default config (B 32, dropout
0.1, chip_smoke.build / train_setup), and prints for each path train
windows/s (median of 10 synchronised steps after 2, host clock), then
over 3 steps (torch.profiler) the device time a step and its busy share
of the unprofiled median step, with the device ms a step of each port
kernel (K6 on the fused path: the block's kernels, its own and the K2
tensor-core kernels it runs; K2 on the others) and chip_smoke's
PROFILE_GROUPS for the rest.  The fixed-order sums of per-tile parts
(``sum_parts``) that K3 and K7 share count as K3's.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

import _ab
from _ab import HERE

# (chip_smoke path, dtype)
CASES = (("LSTM", "bfloat16"), ("GRU", "bfloat16"),
         ("transformer", "bfloat16"), ("LSTM fused", "bfloat16"),
         ("LSTM fused", "float32"), ("LSTM", "float32"))
# ``wide``: (path, dtype) at B 4
WIDE = (("transformer 4096", "bfloat16"),
        ("transformer 4096 float32", "float32"), ("LSTM 4160", "bfloat16"))
# kernel-name fragments (lower case) of K2's launches; on the fused path
# they are K6's, beside its GEMMs and splits ("k6::") or the first body's
# kernels ("attention_block")
K2 = ("relpos_tc", "relpos_attention", "krel_planes", "head_planes",
      "dkrel_windows_reduce", "dkrel_reduce")
KERNELS = (("K7", ("conv_ln",)), ("K3", ("tail_", "sum_parts")),
           ("K5", ("causal_attention", "split_operands")),
           ("K1 / K4", ("lstm_", "gru_", "fwd_cluster_kernel", "cpc::grid::",
                        "split_planes")))


def items(path: str) -> tuple:
    """(group, fragments) of the port's kernels on ``path``."""
    if path == "LSTM fused":
        return (("K6", ("k6::", "attention_block") + K2),) + KERNELS
    return (("K2", K2),) + KERNELS


def one(root: str) -> None:
    """Time the checkout at ``root`` and print one JSON line."""
    sys.path.insert(0, HERE)
    import chip_smoke  # noqa: E402
    _ab.precision_policy()
    sys.path.insert(0, root)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from cpc_audio_tpu_torch.ops import attention_block
    if not os.path.abspath(attention_block.__file__).startswith(
            os.path.abspath(root)):
        raise SystemExit(f"imported {attention_block.__file__}, not "
                         f"{root}'s")
    dev = torch.device("cuda", 0)
    out = {}
    wide = sys.argv[3:] == ["wide"]
    B = 4 if wide else 32
    for path, dtype in WIDE if wide else CASES:
        model, crit = chip_smoke.build(path, dtype,
                                       torch.Generator().manual_seed(1))
        step, batch, key = chip_smoke.train_setup(model.to(dev),
                                                  crit.to(dev), dev, B)
        times = []
        for i in range(12):
            t0 = time.perf_counter()
            step(batch, key=key)
            torch.cuda.synchronize()
            if i >= 2:
                times.append(time.perf_counter() - t0)
        step_ms = statistics.median(times) * 1e3
        n = 3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                step(batch, key=key)
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)
                and e.self_device_time_total > 0]
        groups_of = items(path) + chip_smoke.PROFILE_GROUPS[1:]
        groups = dict.fromkeys([g for g, _ in groups_of] + ["other"], 0.0)
        for e in rows:
            name = e.key.lower()
            group = next((g for g, words in groups_of
                          if any(w in name for w in words)), "other")
            groups[group] += e.self_device_time_total / 1e3 / n
        device_ms = sum(groups.values())
        out[f"{path} {dtype}"] = {
            "windows_s": B * 1e3 / step_ms, "step_ms": step_ms,
            "device_ms": device_ms, "busy": device_ms / step_ms,
            "launches": sum(e.count for e in rows) // n, "groups": groups}
        del model, crit, step, batch, key, prof
        torch.cuda.empty_cache()
    print(json.dumps(out))


def report(who: str, root: str, res: dict) -> None:
    for case, t in res.items():
        print(f"{who} ({root}) {case}: {t['windows_s']:.1f} train "
              f"windows/s ({t['step_ms']:.3f} ms), device {t['device_ms']:.3f}"
              f" ms a step ({100 * t['busy']:.1f} % busy, {t['launches']} "
              f"launches): " + ", ".join(f"{g} {v:.3f}" for g, v in
                                         t["groups"].items()), flush=True)


def main() -> None:
    _ab.main(__file__, one, report, (), __doc__)
    if len(sys.argv) >= 2 and sys.argv[1] != "--one":   # the runs' card
        sys.path.insert(0, HERE)
        import chip_smoke  # noqa: E402
        print(chip_smoke.gpu_line(), flush=True)


if __name__ == "__main__":
    main()
