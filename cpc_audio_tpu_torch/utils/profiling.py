"""Throughput and profiler traces (cpc_audio_tpu/utils/profiling.py):
windows/s and windows/s per device of an epoch, and a ``torch.profiler``
trace in place of ``jax.profiler``'s."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


class ThroughputMeter:
    """Windows/s (and per device) since the last :meth:`reset`; the
    caller counts the global batch of every step."""

    def __init__(self, n_devices: int = 1):
        self.n_devices = n_devices
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._windows = 0
        self._steps = 0

    def update(self, batch_size: int) -> None:
        self._windows += batch_size
        self._steps += 1

    @property
    def windows_per_sec(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._windows / dt if dt > 0 else 0.0

    @property
    def windows_per_sec_per_chip(self) -> float:
        return self.windows_per_sec / max(self.n_devices, 1)

    def summary(self) -> str:
        return (f"{self.windows_per_sec:.1f} windows/s "
                f"({self.windows_per_sec_per_chip:.1f} windows/s/chip, "
                f"{self._steps} steps)")


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """``torch.profiler`` over the block (the host, and the card where
    there is one), written to ``log_dir/trace.json`` as a chrome trace;
    nothing when ``log_dir`` is None."""
    if not log_dir:
        yield
        return
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts, on_trace_ready=lambda p: p.export_chrome_trace(
                os.path.join(log_dir, "trace.json"))):
        yield
