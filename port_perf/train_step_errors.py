#!/usr/bin/env python3
"""Where a float32 train step on the card departs from the CPU's.

Usage, from the root of a checkout:
    python3 port_perf/train_step_errors.py PATH [PATH ...]

PATH is a train path of chip_smoke.py (e.g. "LSTM 768", "LSTM 1056") or
"LSTM D" for any width D (--hiddenEncoder D --hiddenGar D).  For each,
one float32 train step on a (2, 1, sizeWindow) batch, as
chip_smoke.check_train_against_cpu runs it (same weights, round keys and
dropout seed), three times: on the card with cuDNN's convolutions, on
the card with cuDNN switched off (PyTorch's own CUDA convolutions), and on
the CPU (the port's plain versions); then once more on the CPU with the
encoder's ReLU units that the first card run and the CPU put on opposite
sides of 0, within float32 rounding of it, taken on the card's side
(chip_smoke.encoder_relu_kinks).  Prints the largest gradient leaves'
2-norm errors relative to each CPU run, and each encoder layer's
ChannelNorm output error.  TF32 is off throughout.
"""

from __future__ import annotations

import copy
import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke  # noqa: E402


def step_grads(path: str, device: torch.device, cudnn: bool,
               relu: dict = None):
    from cpc_audio_tpu_torch.parallel.train_step import (create_train_state,
                                                         epoch_key,
                                                         make_train_step)
    if path not in chip_smoke.PATH_KERNELS:
        D = int(path.split()[1])
        chip_smoke.PATH_CONFIG[path] = {"hiddenEncoder": D, "hiddenGar": D}
    model, crit = chip_smoke.build(path, "float32",
                                   torch.Generator().manual_seed(
                                       chip_smoke.SEED + 4))
    batch = chip_smoke.synthetic_audio(model.config.sizeWindow, 2,
                                       chip_smoke.SEED + 4)
    torch.backends.cudnn.enabled = cudnn
    try:
        state = create_train_state(copy.deepcopy(model), copy.deepcopy(crit),
                                   device)
        feats = {}
        hooks = [m.register_forward_hook(
            lambda mod, i, o, n=name: feats.__setitem__(
                n, o.detach().float().cpu()))
            for name, m in state.model.gEncoder.named_children()]
        with chip_smoke.encoder_relu_kinks(state.model, relu) \
                if relu is not None else chip_smoke.contextlib.nullcontext():
            _, met = make_train_step(state, device)(
                batch, key=epoch_key(chip_smoke.SEED, 0, device))
        for h in hooks:
            h.remove()
    finally:
        torch.backends.cudnn.enabled = True
    grads = {f"{prefix}.{n}": p.grad.detach().float().cpu()
             for prefix, mod in (("model", state.model),
                                 ("criterion", state.criterion))
             for n, p in mod.named_parameters()}
    return met["losses"].float().cpu(), grads, feats


def rel(a, b) -> float:
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def main() -> None:
    if not torch.cuda.is_available() or len(sys.argv) < 2:
        raise SystemExit(__doc__)
    from cpc_audio_tpu_torch import _common
    _common.precision_policy()
    print(chip_smoke.gpu_line(), flush=True)
    dev = torch.device("cuda", 0)
    for path in sys.argv[1:]:
        relu = {}
        runs = {"cuDNN": step_grads(path, dev, True, relu),
                "no cuDNN": step_grads(path, dev, False)}
        cpu = step_grads(path, torch.device("cpu"), True)
        forced = step_grads(path, torch.device("cpu"), True, relu)
        print(f"{path}: encoder ReLU units on opposite sides of 0 on the "
              f"card (cuDNN) and the CPU, within float32 rounding of it: "
              f"{relu['forced']}; farther apart: {relu['apart']}",
              flush=True)
        for who, ref_name, ref in (("cuDNN", "CPU", cpu),
                                   ("no cuDNN", "CPU", cpu),
                                   ("cuDNN", "CPU, card's branches", forced)):
            loss, grads, feats = runs[who]
            errs = sorted(((rel(grads[n], ref[1][n]), n) for n in ref[1]),
                          reverse=True)
            print(f"{path}, card ({who}) vs {ref_name}: losses "
                  f"{rel(loss, ref[0]):.3e}; encoder outputs " +
                  ", ".join(f"{n} {rel(feats[n], ref[2][n]):.3e}"
                            for n in ref[2]), flush=True)
            for e, n in errs[:8]:
                print(f"  {e:.3e}  {n}", flush=True)


if __name__ == "__main__":
    main()
