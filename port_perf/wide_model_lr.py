#!/usr/bin/env python3
"""The LSTM and GRU models alone at --hiddenGar 8192 (chip_smoke.py
``phase_model_alone``): 4 Adam steps in bf16 on a fixed batch, loss
mean(c^2), at Adam rates 1e-3 and 2e-4 (CPCConfig's --learningRate), once
with the AR's kernels (K1 / K4's grid bodies) and once with their plain
versions on the same card (the wrappers' plain route forced), from the
same weights and batch.  Prints each run's losses: whether a loss that
rises comes from the kernels or from the rate.

Usage, on a GPU machine from the repository root:
    python3 port_perf/wide_model_lr.py
"""
import os
import sys
from unittest import mock

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def losses(mode: str, lr: float, plain: bool, H: int = 8192, B: int = 4,
           steps: int = 4) -> list:
    import chip_smoke
    from cpc_audio_tpu_torch.config import CPCConfig
    from cpc_audio_tpu_torch.models import build_model
    from cpc_audio_tpu_torch.ops import _build
    dev = torch.device("cuda", 0)
    cfg = CPCConfig(arMode=mode, hiddenGar=H, compute_dtype="bfloat16")
    model = build_model(cfg, torch.Generator().manual_seed(
        chip_smoke.SEED)).to(dev)
    batch = torch.from_numpy(chip_smoke.synthetic_audio(
        cfg.sizeWindow, B, chip_smoke.SEED + 10)).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    hidden = model.zero_state(B, dev)
    out = []
    route = mock.patch.object(_build, "runs_kernel",
                              lambda *a: False) if plain else \
        mock.patch.object(_build, "runs_kernel", _build.runs_kernel)
    with route:
        for _ in range(steps):
            c, _, _, _ = model(batch, hidden=hidden, train=True)
            loss = (c.float() ** 2).mean()
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            out.append(loss.item())
    return out


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    import chip_smoke
    from cpc_audio_tpu_torch import _common
    from cpc_audio_tpu_torch.ops import _build
    _common.precision_policy()
    _build.library()
    print(chip_smoke.gpu_line(), flush=True)
    for mode in ("GRU", "LSTM"):
        for lr in (1e-3, 2e-4):
            for plain in (False, True):
                got = losses(mode, lr, plain)
                print(f"{mode} --hiddenGar 8192, bf16, Adam lr {lr:g}, "
                      f"{'plain versions' if plain else 'kernels'}: losses "
                      f"{[round(v, 6) for v in got]}", flush=True)
                torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
