"""Logging, seeding and LR scheduling utilities: the port's own copy of
``cpc_audio_tpu/utils/misc.py`` (CPC_audio utils/misc.py:15-121).
"""

from __future__ import annotations

import json
import os
import random
import sys
from copy import deepcopy
from typing import Dict, Optional

import numpy as np


def untensor(d):
    if isinstance(d, list):
        return [untensor(v) for v in d]
    if isinstance(d, dict):
        return {k: untensor(v) for k, v in d.items()}
    if hasattr(d, "tolist"):
        return d.tolist()
    return d


def save_logs(data: dict, path_logs: str) -> None:
    # atomic (tmp + rename) like save_checkpoint: a preemption mid-write
    # must not leave a truncated logs JSON that poisons auto-resume
    tmp = path_logs + ".tmp"
    with open(tmp, "w") as f:
        json.dump(untensor(data), f, indent=2)
    os.replace(tmp, path_logs)


def update_logs(logs: Dict[str, np.ndarray], log_step: int,
                prev_logs: Optional[dict] = None) -> dict:
    """Delta/step averaging (misc.py:30-38)."""
    out = {}
    for key in logs:
        out[key] = deepcopy(logs[key])
        if prev_logs is not None:
            out[key] -= prev_logs[key]
        out[key] /= log_step
    return out


def show_logs(text: str, logs: dict) -> None:
    """Per-prediction-step table (misc.py:41-60)."""
    print("")
    print("-" * 50)
    print(text)
    for key, value in logs.items():
        if key == "iter":
            continue
        arr = np.atleast_1d(np.asarray(value))
        n = arr.shape[0]
        steps = ["Step"] + [str(s) for s in range(1, n + 1)]
        fmt = " ".join("{:>16}" for _ in range(n + 1))
        print(fmt.format(*steps))
        print(fmt.format(key, *[f"{s:10.6f}" for s in arr]))
    print("-" * 50)


def set_seed(seed: Optional[int]) -> int:
    """Python/numpy seeding (misc.py:63-68); the trainer's torch generators
    and epoch keys derive from the returned seed."""
    if seed is None:
        seed = random.randint(0, 2 ** 31)
    random.seed(seed)
    np.random.seed(seed)
    return seed


def cpu_stats() -> None:
    try:
        import psutil
        print(sys.version)
        print(psutil.cpu_percent())
        print(psutil.virtual_memory())
    except ImportError:
        pass


def ramp_scheduling_function(n_epoch_ramp: int, epoch: int) -> float:
    """Linear warmup factor (misc.py:77-81)."""
    if epoch >= n_epoch_ramp:
        return 1.0
    return (epoch + 1) / n_epoch_ramp


def lr_for_epoch(base_lr: float, epoch: int, scheduler_step: int = -1,
                 scheduler_ramp: Optional[int] = None) -> float:
    """Effective LR at a given epoch.

    Combines the reference's LambdaLR ramp and StepLR(gamma=0.5) exactly as
    SchedulerCombiner does (misc.py:84-121, train.py:351-367; goldens in
    utils/unit_tests.py:21-61): both schedulers track the global epoch, so
    lr = base * ramp(epoch) * 0.5^floor(epoch / step).
    """
    lr = base_lr
    if scheduler_ramp is not None:
        lr *= ramp_scheduling_function(scheduler_ramp, epoch)
    if scheduler_step and scheduler_step > 0:
        lr *= 0.5 ** (epoch // scheduler_step)
    return lr
