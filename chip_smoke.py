#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (cpc_audio_tpu_torch) on one NVIDIA GPU.

Usage, from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from cpc_audio_tpu_torch/csrc with nvcc;
  3. for each kernel, at the eval path's exact shapes, in bfloat16 and in
     float32: compare with its plain PyTorch version on the card against a
     stated tolerance, and time both (median of 25 synchronised runs);
  4. the eval path at full width: the default CPCConfig in bfloat16 with
     seeded random weights, make_val_step on a (32, 1, 20480) batch; every
     kernel's launch count must rise during that step; then the same
     weights in float32 on a (2, 1, 20480) batch on the card (kernels)
     and on the CPU (plain versions) must agree; then build_feature on a
     64000-sample WAV must give (1, 400, 256) finite float32 features;
  5. print one JSON line of per-kernel results, the card line again, and
     last the JSON result line.
There is no CPU path: without a CUDA device the script exits with 1.
"""

from __future__ import annotations

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


def compare(name: str, got: torch.Tensor, want: torch.Tensor, atol: float,
            rtol: float, why: str) -> float:
    """Raise unless |got - want| <= atol + rtol*|want| everywhere."""
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name}: {tuple(got.shape)} {got.dtype} vs "
             f"{tuple(want.shape)} {want.dtype}")
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        fail(f"{name}: non-finite output")
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


def kernel_cases(dev: torch.device, dtype: torch.dtype, B: int = 32):
    """(name, kernel call, plain call) at the eval path's shapes: B=32,
    T=128 frames, H=D=256, K=12 heads over W=116 anchors, 8 heads x dk=32,
    FFN width 2048."""
    from cpc_audio_tpu_torch.ops.ffn import layer_tail, layer_tail_ref
    from cpc_audio_tpu_torch.ops.head_attention import (relpos_attention,
                                                        relpos_attention_ref)
    from cpc_audio_tpu_torch.ops.lstm import lstm_fwd, lstm_scan_ref

    g = torch.Generator(device=dev).manual_seed(SEED)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    T, H = 128, 256
    lstm_args = (rand(B, T, 4 * H), rand(4 * H, H, scale=H ** -0.5),
                 rand(B, H, scale=0.1), rand(B, H, scale=0.1))
    K, S, nh, dk = 12, 116, 8, 32
    D, F, M = nh * dk, 2048, B * S
    attn_args = (rand(K, M, D), rand(K, M, D), rand(K, M, D),
                 rand(K, dk, S, scale=0.5))
    tail_args = (rand(K, M, D),
                 (torch.randn(K, D, generator=g, device=dev) * 0.1 + 1),
                 torch.randn(K, D, generator=g, device=dev) * 0.1,
                 rand(K, D, F, scale=D ** -0.5),
                 torch.randn(K, F, generator=g, device=dev) * 0.1,
                 rand(K, F, D, scale=F ** -0.5),
                 torch.randn(K, D, generator=g, device=dev) * 0.1,
                 (torch.randn(K, D, generator=g, device=dev) * 0.1 + 1),
                 torch.randn(K, D, generator=g, device=dev) * 0.1)
    return [
        ("lstm_fwd", lambda: lstm_fwd(*lstm_args)[0],
         lambda: lstm_scan_ref(*lstm_args)[0]),
        ("relpos_attention_fwd", lambda: relpos_attention(*attn_args, B, nh),
         lambda: relpos_attention_ref(*attn_args, B, nh)),
        ("layer_tail_fwd", lambda: layer_tail(*tail_args),
         lambda: layer_tail_ref(*tail_args)),
    ]


# tolerance per (kernel, dtype): (atol, rtol, why)
TOLERANCE = {
    ("lstm_fwd", torch.float32): (2e-4, 0.0, "f32 sums in another order, "
                                  "compounded over 128 serial steps"),
    ("relpos_attention_fwd", torch.float32): (2e-4, 0.0,
                                              "f32 sums in another order"),
    ("layer_tail_fwd", torch.float32): (5e-4, 0.0, "f32 sums of 2048 "
                                        "products in another order"),
    ("lstm_fwd", torch.bfloat16): (1e-2, 2e-2, "bf16 output rounding"),
    ("relpos_attention_fwd", torch.bfloat16): (
        1e-2, 2e-2, "bf16 output rounding; the plain version rounds the "
        "probabilities to bf16"),
    ("layer_tail_fwd", torch.bfloat16): (
        1e-2, 2e-2, "bf16 rounding of y, the hidden and the output"),
}

SOURCES = {
    "lstm_fwd": ("cpc_audio_tpu_torch/csrc/lstm_fwd.cu",
                 "cpc_audio_tpu/ops/pallas/rnn.py:67"),
    "relpos_attention_fwd": ("cpc_audio_tpu_torch/csrc/relpos_attention_fwd.cu",
                             "cpc_audio_tpu/ops/pallas/head_attention.py:114"),
    "layer_tail_fwd": ("cpc_audio_tpu_torch/csrc/layer_tail_fwd.cu",
                       "cpc_audio_tpu/ops/pallas/ffn.py:88"),
}


def phase_kernels(dev: torch.device, B: int = 32) -> dict:
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        print(f"kernels vs plain versions, {str(dtype)[6:]}:", flush=True)
        for name, kernel, plain in kernel_cases(dev, dtype, B):
            got = kernel()
            want = plain()
            torch.cuda.synchronize()
            atol, rtol, why = TOLERANCE[(name, dtype)]
            err = compare(name, got, want, atol, rtol, why)
            ms = median_ms(kernel)
            plain_ms = median_ms(plain)
            print(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
                  f"(median of {ITERS})", flush=True)
            if dtype == torch.bfloat16:
                results[name] = {"max_abs_err": err, "ms": ms,
                                 "plain_ms": plain_ms}
    return results


def counters():
    from cpc_audio_tpu_torch.ops.ffn import layer_tail
    from cpc_audio_tpu_torch.ops.head_attention import relpos_attention
    from cpc_audio_tpu_torch.ops.lstm import lstm_fwd
    return {"lstm_fwd": lstm_fwd, "relpos_attention_fwd": relpos_attention,
            "layer_tail_fwd": layer_tail}


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

    fns = counters()
    for fn in fns.values():
        fn.launches = 0
    hidden, metrics = step(batch, round_keys=keys)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in fns.items()}
    print(f"eval step launches: {launches}", flush=True)
    for name, n in launches.items():
        if n <= 0:
            fail(f"the eval step did not launch {name}")

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
        with wave.open(path, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes((np.clip(wav, -1, 1) * 32767).astype("<i2")
                          .tobytes())
        feats = build_feature(FeatureModule(model), path)
    print(f"build_feature: shape {feats.shape} dtype {feats.dtype}",
          flush=True)
    if feats.shape != (1, 400, 256) or feats.dtype != np.float32 \
            or not np.isfinite(feats).all():
        fail(f"build_feature gave {feats.shape} {feats.dtype}")


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

    timings = phase_kernels(dev)
    launches = phase_eval(dev)
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
