#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (cpc_audio_tpu_torch) on one NVIDIA GPU.

Usage, from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from cpc_audio_tpu_torch/csrc with nvcc (one
     process per source, all at once);
  3. for each kernel, at the train path's exact shapes, in bfloat16 and in
     float32, at dropout rate 0 and 0.1 where the kernel drops: compare
     with its plain PyTorch version on the card (same inputs, same dropout
     seed) against a stated tolerance, and time both (median of 25
     synchronised runs);
  4. the eval path at full width: the default CPCConfig in bfloat16 with
     seeded random weights, make_val_step on a (32, 1, 20480) batch; every
     forward kernel's launch count must rise during that step; then the
     same weights in float32 on a (2, 1, 20480) batch on the card
     (kernels) and on the CPU (plain versions) must agree; then
     build_feature on a 64000-sample WAV must give (1, 400, 256) finite
     float32 features;
  5. the train path, the main path: make_train_step at the same config
     (bf16, B = 32, dropout 0.1 in the heads), 2 warm-up and 10 timed
     steps on a fixed batch; all six kernels' launch counts must rise, the
     losses must be finite and fall; prints train windows/s and the
     step's device time by kernel (torch.profiler); then one float32 step
     on a (2, 1, 20480) batch on the card and on the CPU (same weights,
     round keys and dropout seed) must give the same losses and gradients;
  6. the train CLI (cpc_audio_tpu_torch.train.main) on a synthetic WAV
     tree, default architecture in bf16: one epoch writes checkpoint_0.pt
     and both sidecars, and a rerun with --nEpoch 2 resumes;
  7. print one JSON line of per-kernel results, the card line again, and
     last the JSON result line.
There is no CPU path: without a CUDA device the script exits with 1.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import wave

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 1234
ITERS = 25


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def gpu_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def median_ms(fn, warmup: int = 3, iters: int = ITERS) -> float:
    """Median over ``iters`` synchronised runs of ``fn``, in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _as_float(name: str, got: torch.Tensor, want: torch.Tensor):
    """Both as float32, after checking shape, dtype and finiteness."""
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name}: {tuple(got.shape)} {got.dtype} vs "
             f"{tuple(want.shape)} {want.dtype}")
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        fail(f"{name}: non-finite output")
    return g, w


def compare(name: str, got: torch.Tensor, want: torch.Tensor, atol: float,
            rtol: float, why: str) -> float:
    """Raise unless |got - want| <= atol + rtol*|want| everywhere."""
    g, w = _as_float(name, got, want)
    err = (g - w).abs()
    max_abs = err.max().item()
    max_rel = max_abs / max(w.abs().max().item(), 1e-30)
    ok = bool((err <= atol + rtol * w.abs()).all())
    print(f"  {name}: max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} "
          f"tolerance |d| <= {atol:g} + {rtol:g}*|ref| ({why}): "
          f"{'ok' if ok else 'EXCEEDED'}", flush=True)
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return max_abs


def compare_norm(name: str, got: torch.Tensor, want: torch.Tensor,
                 rel: float, why: str) -> float:
    """Raise unless ||got - want|| <= rel * ||want|| (2-norms): used for
    gradients, where a hidden unit within rounding of the ReLU kink takes
    the other branch in one version and moves one row's contribution."""
    g, w = _as_float(name, got, want)
    err = (g - w).norm().item() / max(w.norm().item(), 1e-30)
    max_abs = (g - w).abs().max().item()
    ok = err <= rel
    print(f"  {name}: rel_norm_err={err:.3e} max_abs_err={max_abs:.3e} "
          f"tolerance ||d|| <= {rel:g}*||ref|| ({why}): "
          f"{'ok' if ok else 'EXCEEDED'}", flush=True)
    if not ok:
        fail(f"{name} disagrees with its reference")
    return max_abs


def kernel_cases(dev: torch.device, dtype: torch.dtype, B: int = 32):
    """(name, rate, kernel call, plain call) at the train path's shapes:
    B=32, T=128 frames, H=D=256, K=12 heads over W=116 anchors, 8 heads x
    dk=32, FFN width 2048.  Backward calls return tuples of gradients, the
    LSTM forward a tuple of outputs."""
    from cpc_audio_tpu_torch.ops import ffn, head_attention as ha, lstm

    g = torch.Generator(device=dev).manual_seed(SEED)

    def rand(*shape, scale=1.0, dt=dtype):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dt)

    seed = torch.tensor([SEED], dtype=torch.int64, device=dev)
    T, H = 128, 256
    lstm_args = (rand(B, T, 4 * H), rand(4 * H, H, scale=H ** -0.5),
                 rand(B, H, scale=0.1), rand(B, H, scale=0.1))
    gates, cs = lstm.lstm_scan_ref(*lstm_args, save_residuals=True)[3:]
    zeros = torch.zeros(B, H, device=dev)      # the carry is not trained
    lstm_bwd_args = (gates, cs, lstm_args[3], rand(B, T, H, scale=0.1),
                     lstm_args[1], zeros, zeros)
    K, S, nh, dk = 12, 116, 8, 32
    D, F, M = nh * dk, 2048, B * S
    attn_args = (rand(K, M, D), rand(K, M, D), rand(K, M, D),
                 rand(K, dk, S, scale=0.5))
    attn_dout = rand(K, M, D, scale=0.1)
    f32 = torch.float32
    tail_args = (rand(K, M, D), rand(K, D, scale=0.1, dt=f32) + 1,
                 rand(K, D, scale=0.1, dt=f32),
                 rand(K, D, F, scale=D ** -0.5),
                 rand(K, F, scale=0.1, dt=f32),
                 rand(K, F, D, scale=F ** -0.5),
                 rand(K, D, scale=0.1, dt=f32),
                 rand(K, D, scale=0.1, dt=f32) + 1,
                 rand(K, D, scale=0.1, dt=f32))
    tail_dout = rand(K, M, D, scale=0.1)
    # the train path's K1 forward also saves gates and cell states
    cases = [("lstm_fwd", 0.0,
              lambda: lstm.lstm_fwd(*lstm_args, save_residuals=True),
              lambda: lstm.lstm_scan_ref(*lstm_args, save_residuals=True)),
             ("lstm_bwd", 0.0, lambda: lstm.lstm_bwd(*lstm_bwd_args),
              lambda: lstm.lstm_bwd_ref(*lstm_bwd_args))]
    for rate in (0.0, 0.1):
        cases += [
            ("relpos_attention_fwd", rate,
             lambda r=rate: ha.relpos_attention_fwd(*attn_args, B, nh, r,
                                                    seed),
             lambda r=rate: ha.relpos_attention_ref(*attn_args, B, nh, r,
                                                    seed)),
            ("relpos_attention_bwd", rate,
             lambda r=rate: ha.relpos_attention_bwd(*attn_args, attn_dout,
                                                    B, nh, r, seed),
             lambda r=rate: ha.relpos_attention_bwd_ref(
                 *attn_args, attn_dout, B, nh, r, seed)),
            ("layer_tail_fwd", rate,
             lambda r=rate: ffn.layer_tail_fwd(*tail_args, r, 1e-5, seed),
             lambda r=rate: ffn.layer_tail_ref(*tail_args, 1e-5, r, seed)),
            ("layer_tail_bwd", rate,
             lambda r=rate: ffn.layer_tail_bwd(*tail_args, tail_dout, r,
                                               1e-5, seed),
             lambda r=rate: ffn.layer_tail_bwd_ref(*tail_args, tail_dout,
                                                   1e-5, r, seed)),
        ]
    return cases


# tolerance per (kernel, dtype): forward (atol, rtol, why), elementwise;
# backward (rel, why) on the 2-norm of each gradient
TOLERANCE = {
    ("lstm_fwd", torch.float32): (2e-4, 0.0, "f32 sums in another order, "
                                  "compounded over 128 serial steps"),
    ("relpos_attention_fwd", torch.float32): (2e-4, 0.0,
                                              "f32 sums in another order"),
    ("layer_tail_fwd", torch.float32): (5e-4, 0.0, "f32 sums of 2048 "
                                        "products in another order"),
    ("lstm_fwd", torch.bfloat16): (1e-2, 2e-2, "bf16 rounding of ys; gates "
                                   "and cell states are f32"),
    ("relpos_attention_fwd", torch.bfloat16): (
        1e-2, 2e-2, "bf16 output rounding; the plain version rounds the "
        "probabilities to bf16"),
    ("layer_tail_fwd", torch.bfloat16): (
        1e-2, 2e-2, "bf16 rounding of y, the hidden and the output"),
    ("lstm_bwd", torch.float32): (1e-4, "f32 sums in another order over "
                                  "128 serial steps"),
    ("relpos_attention_bwd", torch.float32): (
        1e-4, "f32 sums in another order; dkrel over 256 (b, h) blocks"),
    ("layer_tail_bwd", torch.float32): (
        1e-3, "f32 sums of 2048 and 3712 terms in another order, and "
        "ReLU-kink flips of hidden units within rounding of 0"),
    ("lstm_bwd", torch.bfloat16): (1e-4, "f32 state; only dys and W_hh "
                                   "are bf16, read exactly"),
    ("relpos_attention_bwd", torch.bfloat16): (
        2e-2, "bf16 rounding of ds and p*r that flips by one ulp where "
        "the f32 sums before it differ in order"),
    ("layer_tail_bwd", torch.bfloat16): (
        2e-2, "bf16 rounding of y, h, df and dhp that flips by one ulp "
        "where the f32 sums before it differ in order"),
}

SOURCES = {
    "lstm_fwd": ("cpc_audio_tpu_torch/csrc/lstm_fwd.cu",
                 "cpc_audio_tpu/ops/pallas/rnn.py:67"),
    "lstm_bwd": ("cpc_audio_tpu_torch/csrc/lstm_bwd.cu",
                 "cpc_audio_tpu/ops/pallas/rnn.py:97"),
    "relpos_attention_fwd": ("cpc_audio_tpu_torch/csrc/relpos_attention_fwd.cu",
                             "cpc_audio_tpu/ops/pallas/head_attention.py:114"),
    "relpos_attention_bwd": ("cpc_audio_tpu_torch/csrc/relpos_attention_bwd.cu",
                             "cpc_audio_tpu/ops/pallas/head_attention.py:158"),
    "layer_tail_fwd": ("cpc_audio_tpu_torch/csrc/layer_tail_fwd.cu",
                       "cpc_audio_tpu/ops/pallas/ffn.py:88"),
    "layer_tail_bwd": ("cpc_audio_tpu_torch/csrc/layer_tail_bwd.cu",
                       "cpc_audio_tpu/ops/pallas/ffn.py:121"),
}

# The train path runs K2 and K3 at dropout 0.1: the JSON line reports
# each kernel in bf16 at the rate the train step gives it.
TRAIN_RATE = {"lstm_fwd": 0.0, "lstm_bwd": 0.0}


def phase_kernels(dev: torch.device, B: int = 32) -> dict:
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        print(f"kernels vs plain versions, {str(dtype)[6:]}:", flush=True)
        for name, rate, kernel, plain in kernel_cases(dev, dtype, B):
            got = kernel()
            want = plain()
            torch.cuda.synchronize()
            label = f"{name} rate {rate:g}"
            if not isinstance(got, tuple):
                got, want = (got,), (want,)
            if name.endswith("_bwd"):
                rel, why = TOLERANCE[(name, dtype)]
                err = max(compare_norm(f"{label} grad {i}", gi, wi, rel, why)
                          for i, (gi, wi) in enumerate(zip(got, want)))
            else:
                atol, rtol, why = TOLERANCE[(name, dtype)]
                err = max(compare(f"{label} out {i}", gi, wi, atol, rtol, why)
                          for i, (gi, wi) in enumerate(zip(got, want)))
            del got, want
            ms = median_ms(kernel)
            plain_ms = median_ms(plain)
            print(f"  {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
                  f"(median of {ITERS})", flush=True)
            if dtype == torch.bfloat16 and rate == TRAIN_RATE.get(name, 0.1):
                results[name] = {"max_abs_err": err, "ms": ms,
                                 "plain_ms": plain_ms}
        torch.cuda.empty_cache()
    return results


def counters():
    from cpc_audio_tpu_torch.ops import ffn, head_attention, lstm
    return {"lstm_fwd": lstm.lstm_fwd, "lstm_bwd": lstm.lstm_bwd,
            "relpos_attention_fwd": head_attention.relpos_attention,
            "relpos_attention_bwd": head_attention.relpos_attention_bwd,
            "layer_tail_fwd": ffn.layer_tail,
            "layer_tail_bwd": ffn.layer_tail_bwd}


def reset_counts() -> dict:
    fns = counters()
    for fn in fns.values():
        fn.launches = 0
    return fns


def read_counts(fns: dict, path: str, names) -> dict:
    launches = {name: fn.launches for name, fn in fns.items()}
    print(f"{path} launches: {launches}", flush=True)
    for name in names:
        if launches[name] <= 0:
            fail(f"the {path} did not launch {name}")
    return launches


def round_keys(seed: int) -> torch.Tensor:
    from cpc_audio_tpu_torch.ops.feistel import ROUNDS
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 2 ** 32, (ROUNDS,), generator=g,
                         dtype=torch.int64)


def synthetic_audio(n: int, batch: int, seed: int) -> np.ndarray:
    """Tones plus noise, (batch, 1, n) float32 in [-1, 1]."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    f0 = rng.uniform(100, 400, size=(batch, 1))
    x = 0.3 * np.sin(2 * np.pi * f0 * t) + 0.05 * rng.standard_normal(
        (batch, n))
    return x[:, None, :].astype(np.float32)


def phase_eval(dev: torch.device, B: int = 32) -> dict:
    from cpc_audio_tpu.config import CPCConfig
    from cpc_audio_tpu_torch.criterion import build_criterion
    from cpc_audio_tpu_torch.models import build_model
    from cpc_audio_tpu_torch.parallel.train_step import make_val_step

    cfg = CPCConfig(compute_dtype="bfloat16")
    gen = torch.Generator().manual_seed(SEED)
    model = build_model(cfg, gen).to(dev)
    crit = build_criterion(cfg, gen).to(dev)
    step = make_val_step(model, crit, dev)
    batch = torch.from_numpy(synthetic_audio(cfg.sizeWindow, B, SEED)).to(dev)
    keys = round_keys(SEED)

    fns = reset_counts()
    hidden, metrics = step(batch, round_keys=keys)
    torch.cuda.synchronize()
    launches = read_counts(fns, "eval step",
                           [n for n in SOURCES if n.endswith("_fwd")])

    K = cfg.nPredicts
    losses, acc = metrics["losses"].float().cpu(), metrics["acc"].cpu()
    print(f"eval step (B={B}, bf16): losses={losses.numpy().round(4)} "
          f"acc={acc.numpy().round(4)}", flush=True)
    if tuple(losses.shape) != (K,) or tuple(acc.shape) != (K,):
        fail(f"metrics shapes {tuple(losses.shape)} {tuple(acc.shape)}")
    if not (torch.isfinite(losses).all() and torch.isfinite(acc).all()):
        fail("non-finite losses or accuracies")
    if not ((acc >= 0).all() and (acc <= 1).all()):
        fail("accuracy outside [0, 1]")
    for h in hidden:
        if tuple(h.shape) != (1, B, cfg.hiddenGar) or \
                not torch.isfinite(h.float()).all():
            fail(f"bad hidden state {tuple(h.shape)}")

    times = []
    for i in range(12):
        t0 = time.perf_counter()
        step(batch, round_keys=keys)
        torch.cuda.synchronize()
        if i >= 2:                       # two warm-up steps
            times.append(time.perf_counter() - t0)
    step_ms = statistics.median(times) * 1e3
    windows_per_s = B / (step_ms / 1e3)
    print(f"eval windows/s: {windows_per_s:.1f} (make_val_step, B={B}, "
          f"bf16, median step {step_ms:.3f} ms of 10) on {gpu_line()}",
          flush=True)

    check_against_cpu(cfg, model, dev)
    check_features(model, dev)
    return launches


def check_against_cpu(cfg, model, dev: torch.device) -> None:
    """Same weights in float32: kernels on the card vs plain versions on
    the CPU, on a (2, 1, 20480) batch with the same round keys."""
    from cpc_audio_tpu_torch.criterion import build_criterion
    from cpc_audio_tpu_torch.models import build_model
    from cpc_audio_tpu_torch.parallel.train_step import make_val_step

    cfg32 = cfg.replace(compute_dtype="float32")
    gen = torch.Generator().manual_seed(SEED + 1)
    crit = build_criterion(cfg32, gen)
    results = []
    batch = synthetic_audio(cfg.sizeWindow, 2, SEED + 1)
    keys = round_keys(SEED + 1)
    for device in (dev, torch.device("cpu")):
        m = build_model(cfg32)
        m.load_state_dict(model.state_dict())
        m.to(device)
        crit.to(device)
        c, z, _, _ = m(torch.from_numpy(batch).to(device))
        _, met = make_val_step(m, crit, device)(batch, round_keys=keys)
        results.append([t.detach().float().cpu()
                        for t in (c, z, met["losses"], met["acc"])])
    (c_g, z_g, l_g, a_g), (c_c, z_c, l_c, a_c) = results
    print("float32 eval path, card (kernels) vs CPU (plain versions):",
          flush=True)
    compare("z", z_g, z_c, 1e-4, 1e-4, "f32 convs in another order")
    compare("c", c_g, c_c, 1e-3, 1e-3, "f32, 128 LSTM steps")
    compare("losses", l_g, l_c, 1e-3, 1e-3, "f32 through heads and InfoNCE")
    # an anchor whose positive and best negative differ by less than the
    # f32 noise may flip: allow two of the 2*116 anchors per step
    compare("acc", a_g, a_c, 2.0 / 232 + 1e-6, 0.0, "argmax ties")


def check_features(model, dev: torch.device) -> None:
    from cpc_audio_tpu_torch.feature_loader import FeatureModule, build_feature

    wav = synthetic_audio(64000, 1, SEED + 2)[0, 0]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "smoke.wav")
        _write_wav(path, wav)
        feats = build_feature(FeatureModule(model), path)
    print(f"build_feature: shape {feats.shape} dtype {feats.dtype}",
          flush=True)
    if feats.shape != (1, 400, 256) or feats.dtype != np.float32 \
            or not np.isfinite(feats).all():
        fail(f"build_feature gave {feats.shape} {feats.dtype}")


def phase_train(dev: torch.device, B: int = 32) -> dict:
    """The train path: make_train_step at the default config in bf16."""
    from cpc_audio_tpu.config import CPCConfig
    from cpc_audio_tpu_torch.criterion import build_criterion
    from cpc_audio_tpu_torch.models import build_model
    from cpc_audio_tpu_torch.parallel.train_step import (create_train_state,
                                                         epoch_key,
                                                         make_train_step)

    cfg = CPCConfig(compute_dtype="bfloat16")
    gen = torch.Generator().manual_seed(SEED)
    state = create_train_state(build_model(cfg, gen),
                               build_criterion(cfg, gen), dev,
                               cfg.learningRate)
    step = make_train_step(state, dev)
    batch = torch.from_numpy(synthetic_audio(cfg.sizeWindow, B,
                                             SEED + 3)).to(dev)
    key = epoch_key(SEED, 0, dev)

    fns = reset_counts()
    losses, times = [], []
    for i in range(12):                  # 2 warm-up, 10 timed
        t0 = time.perf_counter()
        _, metrics = step(batch, key=key)
        torch.cuda.synchronize()
        if i >= 2:
            times.append(time.perf_counter() - t0)
        losses.append(metrics["losses"])
    launches = read_counts(fns, "train step", list(SOURCES))

    per_step = torch.stack(losses).float().cpu()          # (12, K)
    if tuple(per_step.shape) != (12, cfg.nPredicts) or \
            not torch.isfinite(per_step).all():
        fail(f"train losses {tuple(per_step.shape)} not finite")
    total = per_step.sum(dim=1)
    print(f"train step losses (sum over K, steps 1-12): "
          f"{[round(v, 4) for v in total.tolist()]}", flush=True)
    first, last = total[2:5].mean().item(), total[-3:].mean().item()
    if not last < first:
        fail(f"the loss did not fall over the timed steps on a fixed batch "
             f"({first:.4f} -> {last:.4f})")
    step_ms = statistics.median(times) * 1e3
    print(f"train windows/s: {B / (step_ms / 1e3):.1f} (make_train_step, "
          f"B={B}, bf16, dropout 0.1, median step {step_ms:.3f} ms of 10, "
          f"min {min(times) * 1e3:.3f} max {max(times) * 1e3:.3f}) on "
          f"{gpu_line()}", flush=True)
    profile_train(step, batch, key, step_ms)
    return launches


def profile_train(step, batch, key, step_ms: float, n: int = 3) -> None:
    """Device time by kernel over ``n`` train steps (torch.profiler), and
    the device's busy share of the unprofiled median step ``step_ms``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step(batch, key=key)
        torch.cuda.synchronize()
    # device-side events only (kernels, copies): the CPU ops that launched
    # them, and the device ranges of annotations such as the optimizer
    # step, report the same time again
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.self_device_time_total > 0]
    rows.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in rows) / 1e3 / n
    print(f"train step profile ({n} steps): {len(rows)} distinct kernels, "
          f"{sum(e.count for e in rows) // n} launches and {busy:.3f} ms of "
          f"device time per step; the unprofiled step takes {step_ms:.3f} "
          f"ms, so the device is busy {100 * busy / step_ms:.1f} % of it. "
          f"Device ms per step by kernel:", flush=True)
    for e in rows[:25]:
        print(f"  {e.self_device_time_total / 1e3 / n:9.3f} ms  "
              f"{e.count // n:5d}x  {e.key[:100]}", flush=True)
    rest = rows[25:]
    print(f"  {sum(e.self_device_time_total for e in rest) / 1e3 / n:9.3f} "
          f"ms  {sum(e.count for e in rest) // n:5d}x  the other "
          f"{len(rest)} kernels", flush=True)
    groups, other = {}, []
    for e in rows:
        name = e.key.lower()
        group = next((g for g, words in PROFILE_GROUPS
                      if any(w in name for w in words)), "other")
        groups[group] = groups.get(group, 0.0) + e.self_device_time_total
        if group == "other":
            other.append(e)
    print("  by group: " + ", ".join(
        f"{g} {t / 1e3 / n:.3f} ms" for g, t in
        sorted(groups.items(), key=lambda kv: -kv[1])), flush=True)
    if other:
        print("  largest of 'other': " + "; ".join(
            f"{e.key[:60]} {e.self_device_time_total / 1e3 / n:.3f} ms"
            for e in other[:6]), flush=True)


# kernel-name fragments (lower case) of the profile's groups, first match
PROFILE_GROUPS = (
    ("port kernels", ("lstm_fwd_kernel", "lstm_bwd_kernel",
                      "relpos_attention", "tail_", "dkrel_reduce")),
    ("Adam (foreach kernels)", ("adam", "multi_tensor_apply")),
    ("cuDNN conv", ("cudnn", "conv", "nchwtonhwc", "nhwctonchw", "wgrad",
                    "dgrad")),
    ("GEMM", ("gemm", "xmma", "cutlass", "sm90_", "nvjet")),
    ("copies and casts", ("copy", "memcpy", "memset")),
    ("reductions", ("reduce_kernel",)),
    ("elementwise", ("elementwise", "index", "gather", "scatter")),
)


def check_train_against_cpu(dev: torch.device) -> None:
    """One float32 train step on a (2, 1, 20480) batch, kernels on the
    card vs plain versions on the CPU: same weights, round keys and
    dropout seed (the dropout bits do not depend on the device)."""
    from cpc_audio_tpu.config import CPCConfig
    from cpc_audio_tpu_torch.criterion import build_criterion
    from cpc_audio_tpu_torch.models import build_model
    from cpc_audio_tpu_torch.parallel.train_step import (create_train_state,
                                                         epoch_key,
                                                         make_train_step)

    cfg = CPCConfig(compute_dtype="float32")
    gen = torch.Generator().manual_seed(SEED + 4)
    model, crit = build_model(cfg, gen), build_criterion(cfg, gen)
    batch = synthetic_audio(cfg.sizeWindow, 2, SEED + 4)
    results = []
    for device in (dev, torch.device("cpu")):
        state = create_train_state(copy.deepcopy(model),
                                   copy.deepcopy(crit), device)
        _, met = make_train_step(state, device)(
            batch, key=epoch_key(SEED, 0, device))
        grads = {f"{prefix}.{n}": p.grad.detach().float().cpu()
                 for prefix, mod in (("model", state.model),
                                     ("criterion", state.criterion))
                 for n, p in mod.named_parameters()}
        results.append((met["losses"].float().cpu(), grads))
    (l_g, g_g), (l_c, g_c) = results
    print("float32 train step, card (kernels) vs CPU (plain versions), "
          "dropout on:", flush=True)
    compare("train losses", l_g, l_c, 1e-3, 1e-3,
            "f32 through 128 LSTM steps, heads and InfoNCE")
    for name in sorted(g_c):
        compare_norm(f"grad {name}", g_g[name], g_c[name], 1e-3,
                     "f32 sums in another order through the whole step, "
                     "cuDNN convs, ReLU-kink flips")


def _write_wav(path: str, samples: np.ndarray) -> None:
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(samples, -1, 1) * 32767).astype("<i2")
                      .tobytes())


def phase_cli(tmp: str) -> None:
    """cpc_audio_tpu_torch.train.main on a synthetic 2-speaker WAV tree at
    the default architecture in bf16: one epoch, then a resume to two."""
    from cpc_audio_tpu_torch import train

    db, out = os.path.join(tmp, "db"), os.path.join(tmp, "ckpt")
    rng = np.random.default_rng(SEED + 5)
    for i in range(16):
        spk = os.path.join(db, f"spk{i % 2}")
        os.makedirs(spk, exist_ok=True)
        n = int(16000 * rng.uniform(3.0, 4.0))
        t = np.arange(n) / 16000.0
        x = 0.3 * np.sin(2 * np.pi * (150 + 100 * (i % 2)) * t) \
            + 0.05 * rng.standard_normal(n)
        _write_wav(os.path.join(spk, f"f{i:03d}.wav"), x)
    argv = ["--pathDB", db, "--file_extension", ".wav",
            "--pathCheckpoint", out, "--compute_dtype", "bfloat16",
            "--batchSizeGPU", "8", "--nEpoch", "1", "--n_process_loader",
            "2", "--ignore_cache", "--random_seed", str(SEED)]
    for n_epoch, want in (("1", "checkpoint_0.pt"), ("2", "checkpoint_1.pt")):
        argv[argv.index("--nEpoch") + 1] = n_epoch
        fns = reset_counts()
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            rc = train.main(argv)
        torch.cuda.synchronize()
        lines = log.getvalue().splitlines()
        print(f"train CLI --nEpoch {n_epoch}: rc={rc} in "
              f"{time.perf_counter() - t0:.1f} s; "
              f"{[ln for ln in lines if 'Resuming' in ln or 'throughput' in ln]}",
              flush=True)
        read_counts(fns, f"train CLI (--nEpoch {n_epoch})", list(SOURCES))
        if rc != 0:
            fail(f"train CLI exited {rc}: {lines[-20:]}")
        files = sorted(os.listdir(out))
        for f in (want, "checkpoint_logs.json", "checkpoint_args.json"):
            if f not in files:
                fail(f"train CLI did not write {f} (found {files})")
    if not any("Resuming from checkpoint" in ln for ln in lines):
        fail("the --nEpoch 2 rerun did not resume")
    with open(os.path.join(out, "checkpoint_logs.json")) as f:
        logs = json.load(f)
    if logs["epoch"] != [0, 1] or not np.isfinite(
            np.asarray(logs["locLoss_train"], np.float64)).all():
        fail(f"train CLI logs: epochs {logs['epoch']}")
    print(f"train CLI: epochs {logs['epoch']}, train loss per epoch "
          f"{[round(float(np.mean(v)), 4) for v in logs['locLoss_train']]}; "
          f"files {files}", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs only on a GPU")
    if not os.path.isdir(os.path.join(HERE, "cpc_audio_tpu_torch")):
        fail(f"cpc_audio_tpu_torch not found beside {__file__}: run from a "
             f"checkout of the repository")
    sys.path.insert(0, HERE)
    import cpc_audio_tpu_torch
    if os.path.dirname(os.path.dirname(cpc_audio_tpu_torch.__file__)) != HERE:
        fail(f"imported {cpc_audio_tpu_torch.__file__}, not the checkout's")
    card = gpu_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    from cpc_audio_tpu_torch.ops import _build
    t0 = time.time()
    _build.library()
    print(f"kernels built in {time.time() - t0:.1f} s: "
          f"{_build.library_path()}", flush=True)
    with open(_build.build_log_path()) as f:
        for line in f:
            if "registers" in line or "spill" in line or "error" in line:
                print("  ptxas:", line.strip())

    t0 = time.time()
    timings = phase_kernels(dev)
    print(f"[phase kernels {time.time() - t0:.1f} s]", flush=True)
    t0 = time.time()
    phase_eval(dev)
    print(f"[phase eval {time.time() - t0:.1f} s]", flush=True)
    t0 = time.time()
    launches = phase_train(dev)
    check_train_against_cpu(dev)
    print(f"[phase train {time.time() - t0:.1f} s]", flush=True)
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        phase_cli(tmp)
    print(f"[phase train CLI {time.time() - t0:.1f} s]", flush=True)
    kernels = [{"name": name, "route": "cuda", "source": SOURCES[name][0],
                "replaces": SOURCES[name][1], "launches": launches[name],
                **timings[name]} for name in SOURCES]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
