#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (cpc_audio_tpu_torch) on one NVIDIA GPU.

Usage, from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from cpc_audio_tpu_torch/csrc with nvcc (one
     process per source, all at once);
  3. for each of the fifteen kernels (K1-K7, forward and backward, and
     K8, the scatter-add), at the train paths' exact shapes, in bfloat16
     and in float32, at dropout rate 0 and 0.1 where the kernel drops:
     compare with its plain PyTorch version on the card (same inputs, same
     dropout seed) against a stated tolerance, time the kernel (device
     time a call: median_ms) and, in bf16 at the train step's rate, its
     plain version, and compute its bound (bytes over the memory rate or
     operations over the peak rate, whichever is larger); K5 and K3 also
     at the widths of --hiddenEncoder 512 --hiddenGar 512 (dk 64, D 512,
     bf16), K2 at those of --sizeWindow 40960 --hiddenEncoder 512 (S 244,
     dk 64, both dtypes); K3 also at D 384 and D 1024 (the widest K2
     takes; both dtypes); K1 also at B 32, T 128, H 512; K2,
     K1 and K3 at the shapes of --hiddenEncoder 768 --hiddenGar 768 (S
     116, dk 96; B 32, T 128, H 768; M 3712, D 768; both dtypes; K1 in
     float32 at H 512 and 768 on its 16-CTA cluster bodies, W_hh in two
     bf16 planes); K3 at D 200 and 1056 (the wide body) in both dtypes
     and at D 2048 in float32, K2 at dk 25 and 132 in both dtypes and K8
     at C 200 and 1056 in float32 (M 3712, S 116: --hiddenEncoder 200,
     1056 and 2048); K5 on its one tensor-core body (float32 on split
     bf16 planes) at dk 256 (N 32, S 128: --hiddenEncoder 2048) and at S
     1024 (N 32, dk 32: --sizeWindow 163840) in both dtypes and at dk 64
     in float32, K2 (at every shape on its tensor-core body, float32 on
     split bf16 planes) at S 1012 (dk 32) and at dk 256 (S 116), K1 and K4 at
     B 4, T 128, H 4096 (--hiddenGar 4096: the grid bodies), both dtypes;
     K1 and K4 forward on their cluster bodies at H 128 (8 CTAs; B 32, T
     128) and at build_feature's B 1 / T 400 (H 256), K1's also as
     build_features_batched runs it, B 8 / T 400 without residuals
     (beside cuDNN's LSTM under inference_mode), and on their rows
     bodies at the --hiddenGar 200 widths (K1 at H 200, K4 at 224), both
     dtypes; every K1 / K4 case on a cluster, grid or resident body
     reruns bit-identically, and its float32 bound counts the 3 bf16
     split products a product takes there (but for the 8-CTA backward at
     H <= 256, the rows bodies and K4's resident forward, exact float32:
     the FP32 cores);
     K8
     also with all keys on one row (bf16), and the
     time of its whole wrapper (sort + searchsorted + K8); K3's forward
     and backward, at each of their shapes at rate 0.1 and in both
     dtypes, must rerun bit-identically, and print the device time of
     each of their launches (in float32 the split of the weights, LN1,
     then G1 and G2 of the forward, or G1-G6 and the sums over tiles of
     the backward); their float32 bounds count the bf16 split products
     they run, at the bf16 peak, beside the float32-core figure; K6's
     forward and backward, at rate 0.1 in both dtypes, the same (its
     GEMMs, its splits and the K2 tensor-core kernels it runs), its
     backward from the forward's residuals (q, k, v, y); K7's forward and
     backward over encoder layers 1-4 in both dtypes the same (its split,
     GEMMs, rows pass and sums), its backward from the forward's yn and
     1 / std; then
     time the yardstick PyTorch call where one computes the same function
     (cuDNN LSTM/GRU, scaled_dot_product_attention, index_add_; also cuDNN's
     LSTM at H 512 and 768 beside K1 there, forward and backward in
     turns at B 8, T 256, H 512 and at B 32, T 128, H 512 and 768, SDPA
     at dk 64 beside K5 at rate 0, in turns, and in float32 cuDNN's LSTM
     and GRU and SDPA at K1's, K4's and K5's shapes beside the float32
     bodies, in turns, SDPA also at dk 256; cuDNN's nn.LSTM at H 1056
     and nn.GRU at H 512 and 768 beside K1's and K4's rows bodies and
     both at B 4, T 128, H 4096 (--hiddenGar 4096), and SDPA at N 32,
     S 1024, dk 32 beside K5 (--sizeWindow 163840), both dtypes, in
     turns), K1's and K4's
     backward beside cuDNN's in both dtypes and the port's whole LSTM and
     GRU layers beside cuDNN's, in turns, K5 at rate 0 beside SDPA, and
     for K7 the port's unfused encoder layers (cuDNN conv + ChannelNorm +
     ReLU, a composition, not one call) and for K6 the heads' unfused
     block (cuBLAS projections + K2 + cuBLAS Wo + residual), each in
     turns with its kernel, both directions, both dtypes;
  4. the eval path at full width, for --arMode LSTM (the default), GRU
     and transformer, and the fused-layer path (LSTM with CPC_ATTN_BLOCK=1
     and CPC_PALLAS_CONV=1: K6 in the heads, K7 in encoder layers 1-4):
     the default CPCConfig in bfloat16 with seeded random weights,
     make_val_step on a (32, 1, 20480) batch; every forward kernel of the
     path must be launched during that step (and K2 not at all on the
     fused path); for LSTM also the step's time, the same weights in
     float32 on a (2, 1, 20480) batch on the card (kernels) and on the CPU
     (plain versions), which must agree, and build_feature on a
     64000-sample WAV, which must give (1, 400, 256) finite float32
     features through K1's cluster forward at B 1 (its latency, the
     median of 10 calls after 2, printed again at the end); then the
     default config at B = 24, where
     negativeSamplingMode auto resolves to the exact sampler;
  5. the train paths, LSTM, GRU, transformer, the fused-layer path, the
     exact sampler on LSTM (negativeSamplingMode exact), the transformer
     at --hiddenEncoder 512 --hiddenGar 512, LSTM at --sizeWindow
     40960 --hiddenEncoder 512 --hiddenGar 512 (B = 8, K2 at S 244),
     LSTM at --hiddenEncoder 768 --hiddenGar 768 (K3 at D 768), the
     default LSTM in float32 (the CLIs' default --compute_dtype), LSTM at
     --hiddenEncoder 512 --hiddenGar 512 and at 768 in float32 (K1's
     float32 16-CTA bodies), and LSTM at --hiddenEncoder 200 and 1056
     (with --hiddenGar the same; K3 at D a multiple of 8 but not of 32,
     and its wide body; K2 at dk 25 and 132), GRU at --hiddenEncoder 512
     --hiddenGar 512 (K4's rows bodies), the transformer in float32 (K5's
     float32 body; its step also held against the CPU), and in float32
     at B = 4 with 4 timed steps the transformer at --hiddenEncoder 2048
     --hiddenGar 2048 (K5 and K2 at dk 256, K3's wide body) and at
     --sizeWindow 163840 (K5 at S 1024, K2 at S 1012):
     make_train_step at the same config (bf16 but on the float32 paths,
     B = 32, dropout 0.1 in the heads and the transformer AR), 2 warm-up
     and 10 timed steps on a
     fixed batch; the launch counts of the path's kernels must rise (on
     the fused path K6 once and K7 four times a step, K2 never; on the
     exact path K8 once a step; on the long-window path K2 once a step),
     K1's and K4's backward must run their cluster body at hiddenGar 256
     and K1's its 16-CTA cluster body at 512 and 768 in both dtypes, K1's
     and K4's forward their 16-CTA cluster body at 256, K1's its 16-CTA
     cluster body at 512 and 768 (the rows body at 200, the grid body at
     1056), K2 on every path that runs
     it its tensor-core body in both directions, once a step
     (head_attention.relpos_attention.body_launches,
     relpos_attention_bwd.body_launches), the losses must be finite
     and fall;
     prints train windows/s and the step's device time by kernel
     (torch.profiler); then (but on the float32 paths, whose steps these
     are: the 768-wide path's step is the float32 768 path's, the
     long-window path's runs K1's float32 bodies at H 512) one float32
     step on a (2, 1, sizeWindow) batch on the card and on the CPU (same
     weights, round keys, negatives' seed and dropout seed; K1's float32
     bodies counted; the encoder's ReLU units within float32 rounding of
     the kink taken on the card's side on the CPU) must give the same
     losses and gradients; then a
     GRU model at --hiddenGar 100 (K4 with H padded to 128: its 8-CTA
     cluster bodies; the criterion must be refused, naming the flag)
     trains alone for 4 steps and holds a float32 step against the CPU,
     and so do a GRU model at --hiddenGar 200 (H 224: K4's rows bodies)
     and LSTM and GRU models at --hiddenGar 4096 (B = 4; K1's and K4's
     grid bodies); then the long-window and wide shapes
     (phase_long_and_wide): K2's tensor-core body at S 2048 and 4084, at
     dk 512 (K 12 x B 4, S 116) and at S 3700 / dk 264 (DKP 512), its
     cluster body past dk 512 at S 116 / dk 520 and 1024 and S 3700 / dk
     520, K5 at S 4096
     and dk 512, K1 and K4 at H 8192, forward and backward in both dtypes
     against their plain versions, K5 beside SDPA and K1 / K4 beside cuDNN
     in turns; the default model and the transformer AR at --sizeWindow
     655360 and the transformer at --hiddenEncoder 4096 --hiddenGar 4096
     (its heads' K2 on the tensor-core body), B = 4, 2 + 4 steps in both
     dtypes, and the default model at --hiddenEncoder 4160 --hiddenGar
     4160 in bf16 (the heads' K2 on its cluster body at dk 520) (losses
     falling, every K2 and K5 call at the path's (S, dk)), and LSTM and
     GRU models alone at --hiddenGar 8192
     (Adam at 2e-4, the float32 step against the CPU); then two exact
     steps with
     stopGradNegatives, in which K8 must not launch;
     last, the default LSTM step in turns with the fused one and with the
     exact one, one line of train windows/s for each pair;
  6. the train CLI (cpc_audio_tpu_torch.train.main) on a synthetic WAV
     tree in bf16: the default architecture for one epoch, which writes
     checkpoint_0.pt and both sidecars, and a rerun with --nEpoch 2 that
     resumes; then one epoch with --arMode GRU, one with --arMode
     transformer, one with --batchSizeGPU 6 (auto -> exact: K8 runs) and
     one with --arMode transformer --hiddenEncoder 512 --hiddenGar 512;
     then one epoch at the CLI's default --compute_dtype float32, which
     must leave TF32 off (the package's precision policy, set by
     train.main), with its first step also run on the CPU from the same
     state, batch and keys, the two held together at 1e-3 of each
     gradient leaf's norm; --arMode GRU --hiddenGar 100 must stop before
     any step, naming the flag;
  6b. interchange (phase_interchange), at the default architecture on the
     same WAV tree: in bf16 and in float32 one CLI epoch with
     --export_torch and `convert export` of its checkpoint, the three files
     through load_model on the card (bit for bit in float32), and a new
     run with --load of the export whose first-step losses must equal the
     trained model's on the same batch; build_features_batched over 12
     ragged WAVs of 3-9 s in 8 lanes of 64000 samples (keep_hidden on and
     off, get_encoded, seq_norm) against per-file build_feature, K1's
     forward on its cluster body once a batch of chunks at B 8, and both
     paths' seconds of audio a second in turns; the hub from a file
     written from the export; one bf16 CLI epoch each of --supervised
     --pathPhone, with --CTC and alone (speaker), and a float32 phone
     epoch whose first step is held against the CPU;
  6c. the eval CLIs (phase_eval_clis), on 6b's default-architecture runs
     and phase_features' 12 WAVs of 3-9 s (the first 9 s) in 3 speaker
     directories: linear_separability for one bf16 epoch each frozen
     (speaker, phone) and --unfrozen --CTC (K1 at B 8 / T 128: without
     residuals and no backward when frozen, with residuals and the
     backward unfrozen), and --unfrozen in float32 with its first step held
     against the CPU; abx_cli from_checkpoint lane-packed, --strict and
     --on_device (within 1e-5 of the host DTW); build_zerospeech_features
     fea (lanes against per-file build_feature), npy --strict --seqNorm and
     --addCriterion with the phone probe (both bit for bit); common_voices
     train (--LSTM, fine-tuned, 2 epochs; K1 forward and backward at B 8 /
     T 900, the model's and the head's) and per (a finite PER; K1 without
     residuals at B 8 / T 900), and a float32 train whose first step is
     held against the CPU; each CLI's seconds (phase 3 also holds K1 at
     both shapes, forward with and without residuals and backward, in both
     dtypes, beside cuDNN's nn.LSTM in turns);
  6d. the non-default variants (phase_variants), at the default widths
     in bf16 with seeded weights, 3 train steps each on a fixed batch
     (finite losses, the AR's K1 each step, train windows/s): --rnnMode
     LSTM --cpc_mode reverse --speakerEmbedding 16 --normMode batchNorm
     (synthetic speaker ids; K1 12 + 12 times a step at the heads' B 32 /
     T 116 / H 256 on its cluster bodies, beside the AR's 1 + 1, and the
     step's torch.profiler split), --rnnMode ffd --encoder_type mfcc,
     --rnnMode conv8 --encoder_type lfb, --rnnMode linear --normMode
     instanceNorm, --rnnMode RNN --normMode ID and --cpc_mode none (losses
     zero, every parameter unchanged); the first path in float32 on a (2,
     1, 20480) batch against the CPU, its first step's gradients at 1e-3
     of each leaf's norm and batchNorm's running statistics after two
     steps; BiDIRARTangled and BiDIRAR alone (B 32 / T 128 / D 256 -> 2 x
     128, two layers, both dtypes: K4's forward and backward on their
     cluster bodies, output and input gradient against the CPU, the time
     of a forward and backward); the learning gate at its defaults on a
     phone-labelled tree the script writes (gate_tree: its JSON line and
     an exit code that agrees with it; the JAX package's gate does not
     clear the margin on that tree either, so the margin waits for the
     reference fixture; K4 at B 8 / T 32 / H 64, its forward on the
     resident body, its backward on the rows body);
     phase 3 also holds K1 and K4 at those three shapes (VARIANT_SHAPES), forward with
     residuals and backward, in both dtypes, beside cuDNN in turns;
  6e. the multi-rank step (phase_ranks, after phase_variants): (a) the
     train CLI with --distributed as torchrun starts one rank (RANK 0,
     WORLD_SIZE 1, NCCL), on phase_cli's tree and flags (default
     architecture, bf16, batch 8), whose logged epoch must equal phase_cli's
     first epoch bit for bit, and NCCL's version; (b) two gloo ranks
     spawned on cuda:0 (the parent built the kernels) at the bench config,
     B 32 a rank, dropout 0.1 in the heads: 3 steps of make_train_step with
     the device scope, 3 with --negative_sampling_scope global and the exact
     sampler (K8 on the 2 * 32 * 128 = 8192 pool rows, held against its
     plain version on rank 0's gradients; rank 0 must draw rows of rank 1),
     then one --normMode batchNorm step (the running statistics the mean of
     the ranks' local updates); after every step the ranks' parameters must
     be bit-identical; the first step is replayed in this process (both
     shards' gradients, each with its rank's streams, summed, one Adam
     step) within 5e-6; prints each rank's K1 / K2 / K3 / K8 launches and
     step ms (host clock), the gloo all_reduce's ms and one step under
     torch.profiler; (c) --nGPU 2 on the one card must run one rank ("Let's
     use 1 devices"); phase 3 holds K8 at the pool's 8192 rows (the JSON
     line's scatter_add_rows_pool) beside index_add_ in turns;
  7. print build_feature's latency again, one JSON line of per-kernel
     results (each kernel's launches from its own path's train run; the
     rows forwards' from the --hiddenGar 200 LSTM path and GRU model),
     the card line again, and last the JSON result line.
The script runs under the package's float32 precision policy (TF32 off:
cpc_audio_tpu_torch/_common.py precision_policy), which it sets first so
that its float32 yardsticks take it too.
There is no CPU path: without a CUDA device the script exits with 1.
"""

from __future__ import annotations

import contextlib
import copy
import glob
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import wave
from collections import Counter

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 1234
RANKS = 2                 # phase_ranks: gloo ranks that share the card
CALLS, REPS = 10, 3       # median_ms: calls per timed run, runs
SPIN_HZ = 1.98e9          # H100 SXM boost clock: torch.cuda._sleep cycles


# lines main prints again at the end, before the JSON lines
SUMMARY = {}


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


def median_ms(fn, warmup: int = 2, calls: int = CALLS,
              reps: int = REPS) -> float:
    """Device time of one call of ``fn``, in ms: up to ``calls`` calls
    (fewer for a slow one, about 25 ms of them) enqueued back to back
    behind a spin kernel long enough to cover their host-side work (the
    wrappers' Python, the plain versions' op dispatch), between two CUDA
    events, so the card never waits on the host inside the interval; the
    median over ``reps`` such runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    whole = time.perf_counter() - t0
    calls = max(1, min(calls, int(0.025 / whole)))
    spin = int(min(1.5 * calls * host + 1e-3, 2.0) * SPIN_HZ)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def host_bound_ms(fn, warmup: int = 3, iters: int = 25) -> float:
    """Median over ``iters`` synchronised runs of ``fn`` between two CUDA
    events, in ms: the earlier measure, in which the card also waits on
    the call's host-side work."""
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


class Case:
    """One kernel call at the train path's shapes: the kernel, its plain
    version, the tensors it reads (for the bytes of its bound), the
    operations it needs (``flops``, 2 per multiply-add, causal pairs only)
    and, where the call needs only part of an input, the bytes it must
    read (``read_bytes``; else every input element counts once)."""

    def __init__(self, name, rate, kernel, plain, inputs, flops,
                 read_bytes=None, label=None, shape=None):
        self.name, self.rate, self.kernel, self.plain = name, rate, kernel, \
            plain
        self.inputs, self.flops, self.read_bytes = inputs, flops, read_bytes
        # bf16 tensor-core products a float32 product takes, where the
        # float32 body runs on split operands (K2, K3, K5; K1's and K4's
        # by body, recurrent_split)
        self.split = SPLIT_PRODUCTS.get(name)
        # shape: None at the default train shapes, else a tag of the wider
        # shape (the --hiddenEncoder 512 --hiddenGar 512 paths)
        self.shape = shape
        self.label = label or (f"{name} rate {rate:g}" +
                               (f" {shape}" if shape else ""))


def kernel_cases(dev: torch.device, dtype: torch.dtype, B: int = 32):
    """Cases at the train path's shapes: B=32, T=128 frames, H=D=256, K=12
    heads over W=116 anchors, 8 heads x dk=32, FFN width 2048, and the
    transformer AR's N = B*8 = 256 rows of S = 128.  Backward calls return
    tuples of gradients, the recurrences' forwards tuples of outputs."""
    from cpc_audio_tpu_torch.ops import (attention_block as ab,
                                         causal_attention as ca, conv_ln as cl,
                                         ffn, gru, head_attention as ha, lstm,
                                         scatter_add as sa)

    g = torch.Generator(device=dev).manual_seed(SEED)

    def rand(*shape, scale=1.0, dt=dtype):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dt)

    seed = torch.tensor([SEED], dtype=torch.int64, device=dev)
    T, H = 128, 256
    lstm_args, lstm_bwd_args, gru_args, gru_bwd_args = recurrent_args(
        rand, dev, B)
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
    N, Sa = B * nh, 128
    causal_args = (rand(N, Sa, dk), rand(N, Sa, dk), rand(N, Sa, dk),
                   rand(N, Sa, Sa, scale=0.5))
    causal_dout = rand(N, Sa, dk, scale=0.1)
    pairs = K * B * nh * S * (S + 1) // 2          # causal (i, j) pairs
    causal_pairs = N * Sa * (Sa + 1) // 2
    # K5 reads q, k, v (and dout) whole but only the bias's causal half,
    # j <= i; the backward still writes all of dbias (zeros above)
    elt = torch.empty((), dtype=dtype).element_size()
    causal_read = (3 * N * Sa * dk + causal_pairs) * elt
    block_args = (rand(M, D),) + tuple(rand(K, D, D, scale=D ** -0.5)
                                       for _ in range(4)) + attn_args[3:]
    proj = 2 * K * M * D * D         # one (M, D) x (D, D) product per k
    # the residuals K6's forward keeps for its backward, (qkv, y)
    block_saved = {r: ab.attention_block_fwd(*block_args, B, nh, r, seed)[1]
                   for r in (0.0, 0.1)}
    # the train path's recurrences also save their residuals
    cases = [Case("lstm_fwd", 0.0,
                  lambda: lstm.lstm_fwd(*lstm_args, save_residuals=True),
                  lambda: lstm.lstm_scan_ref(*lstm_args, save_residuals=True),
                  lstm_args, 2 * B * T * 4 * H * H),
             Case("lstm_bwd", 0.0, lambda: lstm.lstm_bwd(*lstm_bwd_args),
                  lambda: lstm.lstm_bwd_ref(*lstm_bwd_args), lstm_bwd_args,
                  2 * B * T * 4 * H * H),
             Case("gru_fwd", 0.0,
                  lambda: gru.gru_fwd(*gru_args, save_residuals=True),
                  lambda: gru.gru_scan_ref(*gru_args, save_residuals=True),
                  gru_args, 2 * B * T * 3 * H * H),
             Case("gru_bwd", 0.0, lambda: gru.gru_bwd(*gru_bwd_args),
                  lambda: gru.gru_bwd_ref(*gru_bwd_args), gru_bwd_args,
                  2 * B * T * 3 * H * H)]
    for rate in (0.0, 0.1):
        cases += [
            # q.k, q.krel and p.v: 6 dk per causal pair
            Case("relpos_attention_fwd", rate,
                 lambda r=rate: ha.relpos_attention_fwd(*attn_args, B, nh, r,
                                                        seed),
                 lambda r=rate: ha.relpos_attention_ref(*attn_args, B, nh, r,
                                                        seed),
                 attn_args, 6 * dk * pairs),
            # recomputed scores (4 dk), dp, dv, dk, dkrel (2 dk each) and
            # dq = ds.(k + krel) (4 dk): 16 dk per causal pair
            Case("relpos_attention_bwd", rate,
                 lambda r=rate: ha.relpos_attention_bwd(*attn_args, attn_dout,
                                                        B, nh, r, seed),
                 lambda r=rate: ha.relpos_attention_bwd_ref(
                     *attn_args, attn_dout, B, nh, r, seed),
                 attn_args + (attn_dout,), 16 * dk * pairs),
            Case("layer_tail_fwd", rate,
                 lambda r=rate: ffn.layer_tail_fwd(*tail_args, r, 1e-5, seed),
                 lambda r=rate: ffn.layer_tail_ref(*tail_args, 1e-5, r, seed),
                 tail_args, 2 * 2 * K * M * D * F),
            # six products (bf16: the six GEMMs G1-G6)
            Case("layer_tail_bwd", rate,
                 lambda r=rate: ffn.layer_tail_bwd(*tail_args, tail_dout, r,
                                                   1e-5, seed),
                 lambda r=rate: ffn.layer_tail_bwd_ref(*tail_args, tail_dout,
                                                       1e-5, r, seed),
                 tail_args + (tail_dout,), 6 * 2 * K * M * D * F),
            # q.k and p.v: 4 dk per causal pair
            Case("causal_attention_fwd", rate,
                 lambda r=rate: ca.causal_attention_fwd(*causal_args, r,
                                                        seed),
                 lambda r=rate: ca.causal_attention_ref(*causal_args, r,
                                                        seed),
                 causal_args, 4 * dk * causal_pairs, causal_read),
            # recomputed q.k, dp, dv, dq, dk: 10 dk per causal pair
            Case("causal_attention_bwd", rate,
                 lambda r=rate: ca.causal_attention_bwd(*causal_args,
                                                        causal_dout, r, seed),
                 lambda r=rate: ca.causal_attention_bwd_ref(
                     *causal_args, causal_dout, r, seed),
                 causal_args + (causal_dout,), 10 * dk * causal_pairs,
                 causal_read + causal_dout.numel() * elt),
            # the q, k, v and Wo projections and K2's 6 dk per causal pair
            Case("attention_block_fwd", rate,
                 lambda r=rate: ab.attention_block_fwd(*block_args, B, nh, r,
                                                       seed)[0],
                 lambda r=rate: ab.attention_block_ref(*block_args, B, nh, r,
                                                       seed),
                 block_args, 4 * proj + 6 * dk * pairs),
            # from the forward's q, k, v and y (read, not recomputed): dy
            # (1 product), K2's backward (16 dk per causal pair), dWq/k/v/o
            # (4) and dcp (3)
            Case("attention_block_bwd", rate,
                 lambda r=rate: ab.attention_block_bwd(
                     *block_args, attn_dout, block_saved[r], B, nh, r, seed),
                 lambda r=rate: ab.attention_block_bwd_ref(
                     *block_args, attn_dout, B, nh, r, seed),
                 block_args + (attn_dout,) + block_saved[rate],
                 8 * proj + 16 * dk * pairs),
        ]
        # float32: the GEMMs of 6 split products but dcp's 3, K2's backward
        # of 3
        cases[-1].split = (6 * 5 * proj + 3 * 3 * proj + 3 * 16 * dk * pairs) \
            / cases[-1].flops
    layers, dys = conv_layers(rand, B)
    conv_flops = sum(2 * dy.numel() * l[0].shape[-1] * l[6]
                     for l, dy in zip(layers, dys))
    conv_ins = tuple(t for l in layers for t in l[:5])
    # the residuals K7's forward keeps for its backward, (yn, 1 / std)
    conv_saved = [cl.conv_ln_relu_fwd(*l)[1] for l in layers]
    # the four layers of a step: the conv's product (2 s C x C per frame);
    # the backward, from the forward's yn and 1 / std (read, not
    # recomputed), forms dx and dW: 2 products
    cases += [
        Case("conv_ln_fwd", 0.0,
             lambda: tuple(cl.conv_ln_relu_fwd(*l)[0] for l in layers),
             lambda: tuple(cl.conv_ln_relu_ref(*l) for l in layers),
             conv_ins, conv_flops),
        Case("conv_ln_bwd", 0.0,
             lambda: tuple(gr for l, dy, sv in zip(layers, dys, conv_saved)
                           for gr in cl.conv_ln_relu_bwd(*l[:5], dy, sv,
                                                         *l[5:])),
             lambda: tuple(gr for l, dy in zip(layers, dys)
                           for gr in cl.conv_ln_relu_bwd_ref(*l[:5], dy,
                                                             *l[5:])),
             conv_ins + dys + tuple(t for sv in conv_saved for t in sv),
             2 * conv_flops)]
    # K8 on the exact sampler's keys: ms is the kernel on the sorted form,
    # its plain version index_add_ on the keys (the wrapper is timed
    # apart); one add per update element
    if dtype == torch.bfloat16:
        # bf16, the train dtype; the float32 bodies at these widths are held
        # by the float32 train step below and tests/test_torch_cuda.py
        cases += wide_cases(rand, seed, B)
    cases += long_cases(rand, dev, seed)
    cases += tail_cases(rand, seed, B * S, 384, "D 384")
    cases += tail_cases(rand, seed, B * S, 1024, "D 1024")
    cases += h512_cases(rand, dev)
    cases += w768_cases(rand, dev, seed, B)
    cases += width_cases(rand, dev, seed, dtype, B)
    cases += recurrent_cases(rand, dev, GRID_SHAPES)
    cases += recurrent_cases(rand, dev, CLUSTER_FWD_SHAPES, backward=False)
    # the rows bodies at the --hiddenGar 200 widths, both directions
    cases += recurrent_cases(rand, dev, ROWS_FWD_SHAPES)
    cases += features_cases(rand)
    cases += eval_cases(rand, dev)
    cases += variant_cases(rand, dev)
    cases += repair_cases(rand, dev, seed, dtype)
    upd, keys, order, offsets, R = scatter_inputs(dev, dtype, B)
    cases.append(Case("scatter_add_rows", 0.0,
                      lambda: sa.scatter_add_sorted(upd, order, offsets),
                      lambda: sa.scatter_add_rows_ref(upd, keys, R),
                      (upd, order, offsets), upd.numel()))
    if dtype == torch.bfloat16:
        # K8 on the global pool of RANKS ranks (phase_ranks): the same
        # B*W*N keys into RANKS * B * S rows
        pupd, pkeys, porder, poffsets, PR = scatter_inputs(dev, dtype, B,
                                                           world=RANKS)
        case = Case("scatter_add_rows", 0.0,
                    lambda: sa.scatter_add_sorted(pupd, porder, poffsets),
                    lambda: sa.scatter_add_rows_ref(pupd, pkeys, PR),
                    (pupd, porder, poffsets), pupd.numel(),
                    label=f"scatter_add_rows, the global pool of {RANKS} "
                          f"ranks", shape=f"R {PR}")
        case.entry = "scatter_add_rows_pool"
        cases.append(case)
        skeys = torch.full_like(keys, R // 2)
        sorder, soffsets = sa.sort_keys(skeys, R)
        cases.append(Case("scatter_add_rows_skewed", 0.0,
                          lambda: sa.scatter_add_sorted(upd, sorder,
                                                        soffsets),
                          lambda: sa.scatter_add_rows_ref(upd, skeys, R),
                          (upd, sorder, soffsets), upd.numel(),
                          label="scatter_add_rows, all keys on one row"))
    return cases


def recurrent_args(rand, dev: torch.device, B: int = 32, T: int = 128,
                   H: int = 256):
    """Inputs of K1 and K4 at the train shapes, forward and backward; the
    backward's from the plain forward (residuals)."""
    from cpc_audio_tpu_torch.ops import gru, lstm
    lstm_args = (rand(B, T, 4 * H), rand(4 * H, H, scale=H ** -0.5),
                 rand(B, H, scale=0.1), rand(B, H, scale=0.1))
    gates, cs = lstm.lstm_scan_ref(*lstm_args, save_residuals=True)[3:]
    zeros = torch.zeros(B, H, device=dev)      # the carry is not trained
    lstm_bwd_args = (gates, cs, lstm_args[3], rand(B, T, H, scale=0.1),
                     lstm_args[1], zeros, zeros)
    gru_args = (rand(B, T, 3 * H), rand(3 * H, H, scale=H ** -0.5),
                rand(3 * H, scale=0.1), rand(B, H, scale=0.1))
    ys, _, ggates, ghn = gru.gru_scan_ref(*gru_args, save_residuals=True)
    gru_bwd_args = (ggates, ghn, gru_args[3], ys, rand(B, T, H, scale=0.1),
                    gru_args[1], zeros)
    return lstm_args, lstm_bwd_args, gru_args, gru_bwd_args


def long_cases(rand, dev: torch.device, seed, B: int = 8):
    """The kernels of the --sizeWindow 40960 --hiddenEncoder 512
    --hiddenGar 512 LSTM path at its train step's shapes, batch B (the
    train phase's): K2 with S = 244 anchors, dk 64; K1 at T = 256 frames,
    H = 512 (the 16-CTA cluster bodies in bf16, the rows bodies in
    float32); K3 at M = B*244, D = 512."""
    return path_cases(rand, dev, seed, B, S=244, dk=64, T=256, H=512)


def w768_cases(rand, dev: torch.device, seed, B: int = 32):
    """The kernels of the --hiddenEncoder 768 --hiddenGar 768 LSTM path at
    its train step's shapes, batch B: K2 with S = 116 anchors, dk 96; K1
    at T = 128 frames, H = 768 (in bf16 the 16-CTA cluster bodies with
    part of W_hh streamed from L2, in float32 the rows bodies); K3 at
    M = B*116, D = 768 (the widest width class with 256 of its 1024
    columns idle: ragged G2/G4 tiles in bf16, the forward's 16-row blocks
    with 3 output fragments a warp, the float32 forward's second column
    on half of the threads)."""
    return path_cases(rand, dev, seed, B, S=116, dk=96, T=128, H=768)


def path_cases(rand, dev: torch.device, seed, B: int, S: int, dk: int,
               T: int, H: int, K: int = 12, nh: int = 8):
    """The heads' and the LSTM AR's kernels of one train path at its
    step's shapes: K2 at rate 0.1 on K heads of B*S rows, nh heads x dk;
    K1 forward and backward at (B, T, H); K3 at M = B*S, D = nh*dk."""
    from cpc_audio_tpu_torch.ops import lstm
    M, D = B * S, nh * dk
    cases = relpos_cases(rand, seed, B, S, dk, K, nh)
    lstm_args, lstm_bwd_args = recurrent_args(rand, dev, B, T, H)[:2]
    rnn_tag = f"B {B} / T {T} / H {H}"
    return cases + [
        Case("lstm_fwd", 0.0,
             lambda: lstm.lstm_fwd(*lstm_args, save_residuals=True),
             lambda: lstm.lstm_scan_ref(*lstm_args, save_residuals=True),
             lstm_args, 2 * B * T * 4 * H * H, shape=rnn_tag),
        Case("lstm_bwd", 0.0, lambda: lstm.lstm_bwd(*lstm_bwd_args),
             lambda: lstm.lstm_bwd_ref(*lstm_bwd_args), lstm_bwd_args,
             2 * B * T * 4 * H * H, shape=rnn_tag)] + \
        tail_cases(rand, seed, M, D, f"M {M} / D {D}")


def relpos_cases(rand, seed, B: int, S: int, dk: int, K: int = 12,
                 nh: int = 8):
    """K2 forward and backward at rate 0.1 (the train step's) on K heads
    of B*S rows, nh heads x dk."""
    from cpc_audio_tpu_torch.ops import head_attention as ha
    M, D = B * S, nh * dk
    args = (rand(K, M, D), rand(K, M, D), rand(K, M, D),
            rand(K, dk, S, scale=0.5))
    dout = rand(K, M, D, scale=0.1)
    pairs = K * B * nh * S * (S + 1) // 2
    r, tag = 0.1, f"S {S} / dk {dk}"
    return [
        Case("relpos_attention_fwd", r,
             lambda: ha.relpos_attention_fwd(*args, B, nh, r, seed),
             lambda: ha.relpos_attention_ref(*args, B, nh, r, seed), args,
             6 * dk * pairs, shape=tag),
        Case("relpos_attention_bwd", r,
             lambda: ha.relpos_attention_bwd(*args, dout, B, nh, r, seed),
             lambda: ha.relpos_attention_bwd_ref(*args, dout, B, nh, r,
                                                 seed),
             args + (dout,), 16 * dk * pairs, shape=tag)]


def width_cases(rand, dev: torch.device, seed, dtype: torch.dtype,
                B: int = 32):
    """The kernels at --hiddenEncoder widths that are no multiple of 32
    or past 1024 (K 12, S 116 anchors, M = B*116): K3 at D 200 and 1056
    (the wide body: D-wide epilogues across column tiles) and, in float32,
    at D 2048; K2 at dk 25 and 132 (D 200 and 1056); K8 in float32 at C
    200 and 1056 (rows past 4096 bytes walked in pieces), on the exact
    sampler's keys."""
    from cpc_audio_tpu_torch.ops import scatter_add as sa
    S, M = 116, B * 116
    cases = []
    for D in (200, 1056) + ((2048,) if dtype == torch.float32 else ()):
        cases += tail_cases(rand, seed, M, D, f"M {M} / D {D}")
    for dk in (25, 132):
        cases += relpos_cases(rand, seed, B, S, dk)
    if dtype == torch.float32:
        for C in (200, 1056):
            upd, keys, order, offsets, R = scatter_inputs(dev, dtype, B, C)
            cases.append(Case(
                "scatter_add_rows", 0.0,
                lambda u=upd, o=order, f=offsets: sa.scatter_add_sorted(
                    u, o, f),
                lambda u=upd, k=keys, r=R: sa.scatter_add_rows_ref(u, k, r),
                (upd, order, offsets), upd.numel(), shape=f"C {C}"))
    return cases


def causal_cases(rand, seed, N: int, S: int, dk: int, tag: str,
                 rate: float = 0.1):
    """K5 forward and backward at rate ``rate`` on N rows of S with head
    width dk (q, k, v, the bias, then the output's cotangent drawn in
    that order); their bounds read the bias's causal half only."""
    from cpc_audio_tpu_torch.ops import causal_attention as ca
    args = (rand(N, S, dk), rand(N, S, dk), rand(N, S, dk),
            rand(N, S, S, scale=0.5))
    dout = rand(N, S, dk, scale=0.1)
    pairs = N * S * (S + 1) // 2
    elt = args[0].element_size()
    read = (3 * N * S * dk + pairs) * elt
    return [
        # q.k and p.v: 4 dk per causal pair
        Case("causal_attention_fwd", rate,
             lambda: ca.causal_attention_fwd(*args, rate, seed),
             lambda: ca.causal_attention_ref(*args, rate, seed), args,
             4 * dk * pairs, read, shape=tag),
        # recomputed q.k, dp, dv, dq, dk: 10 dk per causal pair
        Case("causal_attention_bwd", rate,
             lambda: ca.causal_attention_bwd(*args, dout, rate, seed),
             lambda: ca.causal_attention_bwd_ref(*args, dout, rate, seed),
             args + (dout,), 10 * dk * pairs, read + dout.numel() * elt,
             shape=tag)]


def repair_cases(rand, dev: torch.device, seed, dtype: torch.dtype,
                 B: int = 4, T: int = 128):
    """The kernels at the shapes the card first took in this form: K5 at
    dk 256 (--hiddenEncoder 2048: N = B*8 rows of S 128) and at S 1024
    (--sizeWindow 163840, dk 32) on its one tensor-core body, and in
    float32 also at dk 64 (N 256, S 128; bf16 has it in wide_cases); K2
    at the heads' S 1012 anchors (dk 32) and at dk 256 (S 116); K1 and K4
    at --hiddenGar 4096 (B 4, T 128: the grid bodies, W_hh streamed from
    device memory every step).  Batch B = 4, the new paths' (rate 0.1
    where a kernel drops)."""
    from cpc_audio_tpu_torch.ops import gru, lstm
    cases = []
    shapes = [(B * 8, 128, 256, "dk 256 / D 2048"),
              (B * 8, 1024, 32, "S 1024 / dk 32")]
    if dtype == torch.float32:
        shapes.insert(0, (256, 128, 64, "dk 64 / D 512"))
    for N, S, dk, tag in shapes:
        cases += causal_cases(rand, seed, N, S, dk, tag)
    cases += relpos_cases(rand, seed, B, 1012, 32)
    cases += relpos_cases(rand, seed, B, 116, 256)
    H = 4096
    la, lba, ga, gba = recurrent_args(rand, dev, B, T, H)
    tag = f"B {B} / T {T} / H {H}"
    cases += [
        Case("lstm_fwd", 0.0, lambda: lstm.lstm_fwd(*la, save_residuals=True),
             lambda: lstm.lstm_scan_ref(*la, save_residuals=True), la,
             2 * B * T * 4 * H * H, shape=tag),
        Case("lstm_bwd", 0.0, lambda: lstm.lstm_bwd(*lba),
             lambda: lstm.lstm_bwd_ref(*lba), lba, 2 * B * T * 4 * H * H,
             shape=tag),
        Case("gru_fwd", 0.0, lambda: gru.gru_fwd(*ga, save_residuals=True),
             lambda: gru.gru_scan_ref(*ga, save_residuals=True), ga,
             2 * B * T * 3 * H * H, shape=tag),
        Case("gru_bwd", 0.0, lambda: gru.gru_bwd(*gba),
             lambda: gru.gru_bwd_ref(*gba), gba, 2 * B * T * 3 * H * H,
             shape=tag)]
    return cases


# the grid bodies' path shapes (csrc/rnn_grid.cuh): K1 at --hiddenGar
# 1056, K4 at the GRU 512 path's width, both at B 32 / T 128 (and at
# --hiddenGar 4096, B 4, in repair_cases); the JSON line's grid entries
# are timed here, in bf16
GRID_SHAPES = (("lstm", 32, 128, 1056), ("gru", 32, 128, 512))
# the cluster forward at H 128 (8 CTAs; the --hiddenGar 100 GRU model's K4
# width) and at build_feature's B 1 / T 400 (every case's h0 and c0 are
# non-zero); the rows bodies at the --hiddenGar 200 widths (K4 pads 200 to
# 224), forward and backward, whose bf16 forward times are the JSON line's
# rows entries
CLUSTER_FWD_SHAPES = (("lstm", 32, 128, 128), ("gru", 32, 128, 128),
                      ("lstm", 1, 400, 256), ("gru", 1, 400, 256))
ROWS_FWD_SHAPES = (("lstm", 32, 128, 200), ("gru", 32, 128, 224))
# K4's resident forward at the learning gate's shape (VARIANT_SHAPES'
# "gate" case), the JSON line's gru_fwd_resident entry
RESIDENT_FWD_SHAPES = (("gru", 8, 32, 64),)
# the H where each recurrence case's body is read (the index of w_hh among
# its inputs)
W_HH_AT = {"lstm_fwd": 1, "lstm_bwd": 4, "gru_fwd": 1, "gru_bwd": 5}


def recurrent_cases(rand, dev: torch.device, shapes,
                    backward: bool = True):
    """K1 (LSTM) or K4 (GRU) forward and (with ``backward``) backward at
    each (kind, B, T, H) of ``shapes``, on whichever body H takes."""
    from cpc_audio_tpu_torch.ops import gru, lstm
    cases = []
    for kind, B, T, H in shapes:
        la, lba, ga, gba = recurrent_args(rand, dev, B, T, H)
        tag = f"B {B} / T {T} / H {H}"
        if kind == "lstm":
            cases += [
                Case("lstm_fwd", 0.0,
                     lambda a=la: lstm.lstm_fwd(*a, save_residuals=True),
                     lambda a=la: lstm.lstm_scan_ref(*a, save_residuals=True),
                     la, 2 * B * T * 4 * H * H, shape=tag),
                Case("lstm_bwd", 0.0, lambda a=lba: lstm.lstm_bwd(*a),
                     lambda a=lba: lstm.lstm_bwd_ref(*a), lba,
                     2 * B * T * 4 * H * H, shape=tag)][:1 + backward]
        else:
            cases += [
                Case("gru_fwd", 0.0,
                     lambda a=ga: gru.gru_fwd(*a, save_residuals=True),
                     lambda a=ga: gru.gru_scan_ref(*a, save_residuals=True),
                     ga, 2 * B * T * 3 * H * H, shape=tag),
                Case("gru_bwd", 0.0, lambda a=gba: gru.gru_bwd(*a),
                     lambda a=gba: gru.gru_bwd_ref(*a), gba,
                     2 * B * T * 3 * H * H, shape=tag)][:1 + backward]
    return cases


def features_args(rand, B: int = 8, T: int = 400, H: int = 256):
    """K1's forward inputs at build_features_batched's shape (8 lanes of
    64000-sample chunks at the default --hiddenGar): x_proj, W_hh and the
    lanes' carried, non-zero h0 and c0."""
    return (rand(B, T, 4 * H), rand(4 * H, H, scale=H ** -0.5),
            rand(B, H, scale=0.1), rand(B, H, scale=0.1))


def features_cases(rand, B: int = 8, T: int = 400, H: int = 256):
    """K1's forward as build_features_batched runs it, under
    inference_mode: without residuals (save_residuals=False), so its bound
    reads x_proj, W_hh, h0, c0 and writes ys, hT, cT only."""
    from cpc_audio_tpu_torch.ops import lstm
    la = features_args(rand, B, T, H)
    tag = f"B {B} / T {T} / H {H}"
    return [Case("lstm_fwd", 0.0, lambda: lstm.lstm_fwd(*la),
                 lambda: lstm.lstm_scan_ref(*la), la, 2 * B * T * 4 * H * H,
                 shape=tag, label=f"lstm_fwd inference {tag}")]


# K1 at the eval CLIs' shapes, the default --hiddenGar: the linear-
# separability probe's B 8 windows of 20480 samples (T 128) and Common
# Voice's B 8 whole utterances padded to the longest, 9 s (T 900)
EVAL_SHAPES = (("probe", 8, 128, 256), ("cv", 8, 900, 256))


def eval_cases(rand, dev: torch.device):
    """K1 at each of EVAL_SHAPES: the forward with residuals (the unfrozen
    probe's and the fine-tuning's train steps), without them (the frozen
    probe, validation and per, under no_grad or inference_mode: its bound
    counts x_proj, W_hh, h0, c0, ys, hT, cT only) and the backward, from a
    non-zero h0 and c0; each case is the JSON line's entry ``case.entry``."""
    from cpc_audio_tpu_torch.ops import lstm
    cases = []
    for cli, B, T, H in EVAL_SHAPES:
        la, lba = recurrent_args(rand, dev, B, T, H)[:2]
        tag = f"B {B} / T {T} / H {H}"
        for name, entry, label, kernel, plain, inputs in (
                ("lstm_fwd", f"lstm_fwd_{cli}", f"lstm_fwd train {tag}",
                 lambda a=la: lstm.lstm_fwd(*a, save_residuals=True),
                 lambda a=la: lstm.lstm_scan_ref(*a, save_residuals=True),
                 la),
                ("lstm_fwd", f"lstm_fwd_{cli}_inference",
                 f"lstm_fwd inference {tag}", lambda a=la: lstm.lstm_fwd(*a),
                 lambda a=la: lstm.lstm_scan_ref(*a), la),
                ("lstm_bwd", f"lstm_bwd_{cli}", f"lstm_bwd {tag}",
                 lambda a=lba: lstm.lstm_bwd(*a),
                 lambda a=lba: lstm.lstm_bwd_ref(*a), lba)):
            case = Case(name, 0.0, kernel, plain, inputs,
                        2 * B * T * 4 * H * H, label=label, shape=tag)
            case.entry = entry
            cases.append(case)
    return cases


# K1 and K4 at the variant paths' shapes (phase_variants): the --rnnMode
# LSTM heads' K1 over the W = 116 anchors at H = hiddenEncoder 256, the
# bidirectional ARs' K4 at H = hiddenGar / 2 = 128, and the learning
# gate's GRU AR (--hiddenGar 64, --sizeWindow 5120, batch 8), its K4
# forward on the resident body, its backward on the rows body
VARIANT_SHAPES = (("heads", "lstm", 32, 116, 256),
                  ("bidir", "gru", 32, 128, 128),
                  ("gate", "gru", 8, 32, 64))


def variant_cases(rand, dev: torch.device):
    """K1 or K4 at each of VARIANT_SHAPES, the forward with residuals (a
    train step's) and the backward, from a non-zero state; each case is
    the JSON line's entry ``case.entry``, ``<kernel>_<tag>``."""
    from cpc_audio_tpu_torch.ops import gru, lstm
    cases = []
    for tag, kind, B, T, H in VARIANT_SHAPES:
        la, lba, ga, gba = recurrent_args(rand, dev, B, T, H)
        shape = f"B {B} / T {T} / H {H}"
        mod, G = (lstm, 4) if kind == "lstm" else (gru, 3)
        fwd_args, bwd_args = (la, lba) if kind == "lstm" else (ga, gba)
        fwd = mod.lstm_fwd if kind == "lstm" else mod.gru_fwd
        fwd_ref = mod.lstm_scan_ref if kind == "lstm" else mod.gru_scan_ref
        bwd = mod.lstm_bwd if kind == "lstm" else mod.gru_bwd
        bwd_ref = mod.lstm_bwd_ref if kind == "lstm" else mod.gru_bwd_ref
        for d, kernel, plain, inputs in (
                ("fwd", lambda a=fwd_args, f=fwd: f(*a, save_residuals=True),
                 lambda a=fwd_args, f=fwd_ref: f(*a, save_residuals=True),
                 fwd_args),
                ("bwd", lambda a=bwd_args, f=bwd: f(*a),
                 lambda a=bwd_args, f=bwd_ref: f(*a), bwd_args)):
            case = Case(f"{kind}_{d}", 0.0, kernel, plain, inputs,
                        2 * B * T * G * H * H, shape=shape,
                        label=f"{kind}_{d} {tag} {shape}")
            case.entry = f"{kind}_{d}_{tag}"
            cases.append(case)
    return cases


def recurrent_body(case: Case, dtype: torch.dtype):
    """The body a K1 / K4 case runs ("rows", "cluster", "grid" or, K4's
    forward, "resident"), or None for the other kernels."""
    if case.name not in W_HH_AT:
        return None
    from cpc_audio_tpu_torch.ops import gru, lstm
    mod = lstm if case.name.startswith("lstm") else gru
    H = case.inputs[W_HH_AT[case.name]].shape[1]
    return (mod.fwd_body if case.name.endswith("_fwd") else
            mod.bwd_body)(H, dtype)


def h512_cases(rand, dev: torch.device, B: int = 32, T: int = 128,
               H: int = 512):
    """K1 forward and backward at H 512 at the default window's B 32,
    T 128 (bf16: the 16-CTA cluster bodies; float32: the rows bodies),
    beside the long-window path's B 8, T 256 (long_cases)."""
    from cpc_audio_tpu_torch.ops import lstm
    fa, args = recurrent_args(rand, dev, B, T, H)[:2]
    tag = f"B {B} / T {T} / H {H}"
    return [Case("lstm_fwd", 0.0,
                 lambda: lstm.lstm_fwd(*fa, save_residuals=True),
                 lambda: lstm.lstm_scan_ref(*fa, save_residuals=True), fa,
                 2 * B * T * 4 * H * H, shape=tag),
            Case("lstm_bwd", 0.0, lambda: lstm.lstm_bwd(*args),
                 lambda: lstm.lstm_bwd_ref(*args), args,
                 2 * B * T * 4 * H * H, shape=tag)]


def tail_cases(rand, seed, M: int, D: int, tag: str, K: int = 12,
               F: int = 2048):
    """K3 forward and backward at rate 0.1 (the train step's) on K heads
    of (M, D) rows with FFN width F."""
    from cpc_audio_tpu_torch.ops import ffn
    f32 = torch.float32
    tail = (rand(K, M, D), rand(K, D, scale=0.1, dt=f32) + 1,
            rand(K, D, scale=0.1, dt=f32), rand(K, D, F, scale=D ** -0.5),
            rand(K, F, scale=0.1, dt=f32), rand(K, F, D, scale=F ** -0.5),
            rand(K, D, scale=0.1, dt=f32),
            rand(K, D, scale=0.1, dt=f32) + 1, rand(K, D, scale=0.1, dt=f32))
    tail_dout = rand(K, M, D, scale=0.1)
    r = 0.1
    return [
        Case("layer_tail_fwd", r,
             lambda: ffn.layer_tail_fwd(*tail, r, 1e-5, seed),
             lambda: ffn.layer_tail_ref(*tail, 1e-5, r, seed), tail,
             2 * 2 * K * M * D * F, shape=tag),
        Case("layer_tail_bwd", r,
             lambda: ffn.layer_tail_bwd(*tail, tail_dout, r, 1e-5, seed),
             lambda: ffn.layer_tail_bwd_ref(*tail, tail_dout, 1e-5, r, seed),
             tail + (tail_dout,), 6 * 2 * K * M * D * F, shape=tag)]


def wide_cases(rand, seed, B: int = 32):
    """K5 and K3 at rate 0.1 (the train step's) at the widths of
    --hiddenEncoder 512 --hiddenGar 512: the transformer AR's N = B*8
    rows of S = 128 with dk = 64, the heads' K = 12, M = B*116, D = 512,
    F = 2048."""
    cases = causal_cases(rand, seed, B * 8, 128, 64, "dk 64 / D 512")
    # drawn after K5's inputs, as they always were
    return cases + tail_cases(rand, seed, B * 116, 512, "dk 64 / D 512")


def scatter_inputs(dev: torch.device, dtype: torch.dtype, B: int = 32,
                   C: int = 256, world: int = 1):
    """K8's inputs on the exact path at batch B: the (B*W*N, C) cotangent
    of the negatives, random, and the sampler's flat pool index (B = 32:
    475,136 keys into R = 4096 rows), with its sorted form; with ``world``
    ranks under --negative_sampling_scope global the keys run over the
    pool of every rank's batch (R = world * B * S: 8192 rows at 2)."""
    from cpc_audio_tpu_torch.criterion import infonce
    from cpc_audio_tpu_torch.ops import dropout
    from cpc_audio_tpu_torch.ops import scatter_add as sa
    S, K, N = 128, 12, 128
    W = S - K
    R = world * B * S
    b, u = dropout.negative_indices(
        torch.tensor([SEED], dtype=torch.int64, device=dev), (B, N, W),
        world * B, S)
    keys = infonce.sample_negatives(
        torch.zeros(B, S, 1, device=dev), W, N, b, u,
        pool=torch.zeros(world * B, S, 1, device=dev))[0].reshape(-1)
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    upd = torch.randn((keys.shape[0], C), generator=g, device=dev).to(dtype)
    return (upd, keys) + sa.sort_keys(keys, R) + (R,)


def conv_layers(rand, B: int = 32):
    """Encoder layers 1-4 at the default config, as the fused path runs
    them: ((x, w, bias, nw, nb, stride, kernel, pad), ...) with x (B, T,
    256) channels-last (T = 4096, 1024, 512, 256; ReLU outputs, so >= 0),
    w (kernel*256, 256), and the outputs' cotangents."""
    from cpc_audio_tpu_torch.models import encoder
    C, T, f32 = 256, 4096, torch.float32
    layers, dys = [], []
    for k, s, p in zip(encoder.CONV_KERNELS[1:], encoder.CONV_STRIDES[1:],
                       encoder.CONV_PADS[1:]):
        layers.append((rand(B, T, C).abs(),
                       rand(k * C, C, scale=(k * C) ** -0.5),
                       rand(C, scale=0.1, dt=f32),
                       rand(C, scale=0.1, dt=f32) + 1,
                       rand(C, scale=0.1, dt=f32), s, k, p))
        T = (T + 2 * p - k) // s + 1
        dys.append(rand(B, T, C, scale=0.1))
    return layers, tuple(dys)


# tolerance per (kernel, dtype): forward (atol, rtol, why), elementwise;
# backward (rel, why) on the 2-norm of each gradient
TOLERANCE = {
    ("lstm_fwd", torch.float32): (2e-4, 0.0, "f32 sums in another order, "
                                  "compounded over 128 serial steps"),
    ("gru_fwd", torch.float32): (2e-4, 0.0, "f32 sums in another order, "
                                 "compounded over 128 serial steps"),
    ("relpos_attention_fwd", torch.float32): (2e-4, 0.0,
                                              "f32 sums in another order"),
    ("layer_tail_fwd", torch.float32): (5e-4, 0.0, "f32 sums of 2048 "
                                        "products in another order; G2 "
                                        "of 3 split products"),
    ("causal_attention_fwd", torch.float32): (2e-4, 0.0,
                                              "f32 sums in another order"),
    ("attention_block_fwd", torch.float32): (2e-4, 0.0, "f32 sums of 256 "
                                             "products in another order"),
    ("conv_ln_fwd", torch.float32): (2e-4, 0.0, "f32 sums of 2048 products "
                                     "in another order, over the channels' "
                                     "std"),
    ("lstm_fwd", torch.bfloat16): (1e-2, 2e-2, "bf16 rounding of ys; gates "
                                   "and cell states are f32"),
    ("gru_fwd", torch.bfloat16): (1e-2, 2e-2, "bf16 rounding of ys; gates "
                                  "and ghn are f32"),
    ("relpos_attention_fwd", torch.bfloat16): (
        1e-2, 2e-2, "bf16 output rounding; the plain version rounds the "
        "probabilities to bf16"),
    ("layer_tail_fwd", torch.bfloat16): (
        1e-2, 2e-2, "bf16 rounding of y, the hidden and the output"),
    ("causal_attention_fwd", torch.bfloat16): (
        1e-2, 2e-2, "bf16 output rounding; both round the probabilities "
        "to bf16, which flips by one ulp where the f32 sums differ in "
        "order"),
    ("attention_block_fwd", torch.bfloat16): (
        2 ** -4, 2e-2, "x = round(c + round(att)), |att| up to 8: where c "
        "and att cancel, a one-ulp flip of round(att) (2^-5 at 4-8) stands "
        "whole beside a small x"),
    ("conv_ln_fwd", torch.bfloat16): (
        1e-2, 2e-2, "bf16 output rounding that flips by one ulp where the "
        "f32 sums before it differ in order"),
    ("scatter_add_rows", torch.float32): (
        1e-4, 1e-5, "f32 sums of ~116 rows in another order; index_add_ "
        "adds with atomics"),
    ("scatter_add_rows", torch.bfloat16): (
        1e-4, 1e-5, "f32 sums of ~116 bf16 rows, each exact in f32, in "
        "another order; index_add_ adds with atomics"),
    ("scatter_add_rows_skewed", torch.bfloat16): (
        1e-4, 1e-3, "f32 sums of 475,136 rows into one, in another order: "
        "each rounding is up to 2^-24 of a partial sum of ~700"),
    ("lstm_bwd", torch.float32): (1e-4, "f32 sums in another order over "
                                  "128 serial steps"),
    ("gru_bwd", torch.float32): (1e-4, "f32 sums in another order over "
                                 "128 serial steps"),
    ("relpos_attention_bwd", torch.float32): (
        1e-4, "f32 sums in another order; dkrel over 256 (b, h) blocks"),
    ("layer_tail_bwd", torch.float32): (
        1e-3, "f32 sums of 2048 and 3712 terms in another order, and "
        "ReLU-kink flips of hidden units within rounding of 0"),
    ("causal_attention_bwd", torch.float32): (
        1e-4, "f32 sums in another order"),
    ("attention_block_bwd", torch.float32): (
        1e-4, "f32 sums in another order; dW over 3712 rows"),
    ("conv_ln_bwd", torch.float32): (
        1e-3, "f32 sums in another order, and ReLU-kink flips of units "
        "within rounding of 0, which move a whole row of dh"),
    ("lstm_bwd", torch.bfloat16): (1e-4, "f32 state; only dys and W_hh "
                                   "are bf16, read exactly"),
    ("gru_bwd", torch.bfloat16): (1e-4, "f32 state; only dys, ys, h0 and "
                                  "W_hh are bf16, read exactly"),
    ("relpos_attention_bwd", torch.bfloat16): (
        2e-2, "bf16 rounding of ds and p*r that flips by one ulp where "
        "the f32 sums before it differ in order"),
    ("layer_tail_bwd", torch.bfloat16): (
        2e-2, "bf16 rounding of y, h, df and dhp that flips by one ulp "
        "where the f32 sums before it differ in order"),
    ("causal_attention_bwd", torch.bfloat16): (
        2e-2, "bf16 rounding of the four outputs, flipping by one ulp "
        "where the f32 sums before it differ in order"),
    ("attention_block_bwd", torch.bfloat16): (
        2e-2, "bf16 rounding of q, k, v, dy, ds, p*r, dq, dk, dv and y "
        "that flips by one ulp where the f32 sums before it differ in "
        "order"),
    ("conv_ln_bwd", torch.bfloat16): (
        2e-2, "bf16 rounding of h's output and of dh that flips by one ulp "
        "where the f32 sums before it differ in order, and ReLU-kink "
        "flips"),
}

SOURCES = {
    # K1's and K4's forward at the default --hiddenGar: the 16-CTA cluster
    # body, one header for both, launched from the kernels' own sources
    # (the rows bodies, csrc/lstm_fwd.cu and csrc/gru_fwd.cu, are the
    # JSON line's *_fwd_rows entries)
    "lstm_fwd": ("cpc_audio_tpu_torch/csrc/rnn_cluster_fwd.cuh",
                 "cpc_audio_tpu/ops/pallas/rnn.py:67"),
    "lstm_bwd": ("cpc_audio_tpu_torch/csrc/lstm_bwd.cu",
                 "cpc_audio_tpu/ops/pallas/rnn.py:97"),
    # K2: the tensor-core body every default-width path runs; past dk 512
    # its cluster body on the same kernels (the *_cluster entries)
    "relpos_attention_fwd": (
        "cpc_audio_tpu_torch/csrc/relpos_attention_tc_fwd.cu",
        "cpc_audio_tpu/ops/pallas/head_attention.py:114"),
    "relpos_attention_bwd": (
        "cpc_audio_tpu_torch/csrc/relpos_attention_tc_bwd.cu",
        "cpc_audio_tpu/ops/pallas/head_attention.py:158"),
    # K3: one body for both directions and both dtypes (bf16 operands as
    # they are, float32 ones split into bf16 planes); its C entry points
    # are in csrc/layer_tail_fwd.cu and csrc/layer_tail_bwd.cu
    "layer_tail_fwd": ("cpc_audio_tpu_torch/csrc/layer_tail_tc.cu",
                       "cpc_audio_tpu/ops/pallas/ffn.py:88"),
    "layer_tail_bwd": ("cpc_audio_tpu_torch/csrc/layer_tail_tc.cu",
                       "cpc_audio_tpu/ops/pallas/ffn.py:121"),
    "gru_fwd": ("cpc_audio_tpu_torch/csrc/rnn_cluster_fwd.cuh",
                "cpc_audio_tpu/ops/pallas/rnn.py:238"),
    "gru_bwd": ("cpc_audio_tpu_torch/csrc/gru_bwd.cu",
                "cpc_audio_tpu/ops/pallas/rnn.py:265"),
    "causal_attention_fwd": ("cpc_audio_tpu_torch/csrc/causal_attention_fwd.cu",
                             "cpc_audio_tpu/ops/pallas/attention.py:81"),
    "causal_attention_bwd": ("cpc_audio_tpu_torch/csrc/causal_attention_bwd.cu",
                             "cpc_audio_tpu/ops/pallas/attention.py:96"),
    "attention_block_fwd": ("cpc_audio_tpu_torch/csrc/attention_block_fwd.cu",
                            "cpc_audio_tpu/ops/pallas/head_attention.py:385"),
    "attention_block_bwd": ("cpc_audio_tpu_torch/csrc/attention_block_bwd.cu",
                            "cpc_audio_tpu/ops/pallas/head_attention.py:421"),
    "conv_ln_fwd": ("cpc_audio_tpu_torch/csrc/conv_ln_fwd.cu",
                    "cpc_audio_tpu/ops/pallas/conv_ln.py:94"),
    "conv_ln_bwd": ("cpc_audio_tpu_torch/csrc/conv_ln_bwd.cu",
                    "cpc_audio_tpu/ops/pallas/conv_ln.py:105"),
    "scatter_add_rows": ("cpc_audio_tpu_torch/csrc/scatter_add.cu",
                         "cpc_audio_tpu/ops/pallas/scatter_add.py:39"),
    # K8 under --negative_sampling_scope global on RANKS ranks
    # (phase_ranks): the keys of the pool of every rank's batch
    "scatter_add_rows_pool": ("cpc_audio_tpu_torch/csrc/scatter_add.cu",
                              "cpc_audio_tpu/ops/pallas/scatter_add.py:39"),
    # K1's and K4's grid bodies (W_hh split over every SM), one header for
    # both, launched from the kernels' own sources: the JSON line's entries
    # at the --hiddenGar 1056 (K1) and GRU 512 (K4) paths' shapes
    "lstm_fwd_grid": ("cpc_audio_tpu_torch/csrc/rnn_grid.cuh",
                      "cpc_audio_tpu/ops/pallas/rnn.py:67"),
    "lstm_bwd_grid": ("cpc_audio_tpu_torch/csrc/rnn_grid.cuh",
                      "cpc_audio_tpu/ops/pallas/rnn.py:97"),
    "gru_fwd_grid": ("cpc_audio_tpu_torch/csrc/rnn_grid.cuh",
                     "cpc_audio_tpu/ops/pallas/rnn.py:238"),
    "gru_bwd_grid": ("cpc_audio_tpu_torch/csrc/rnn_grid.cuh",
                     "cpc_audio_tpu/ops/pallas/rnn.py:265"),
    # the rows forwards, at the widths with no cluster or grid body: K1 at
    # --hiddenGar 200, K4 at 200 padded to 224
    "lstm_fwd_rows": ("cpc_audio_tpu_torch/csrc/lstm_fwd.cu",
                      "cpc_audio_tpu/ops/pallas/rnn.py:67"),
    "gru_fwd_rows": ("cpc_audio_tpu_torch/csrc/gru_fwd.cu",
                     "cpc_audio_tpu/ops/pallas/rnn.py:238"),
    # K1's forward cluster body at build_features_batched's B 8 / T 400 /
    # H 256, from the lanes' carried state, without residuals
    "lstm_fwd_features": ("cpc_audio_tpu_torch/csrc/rnn_cluster_fwd.cuh",
                          "cpc_audio_tpu/ops/pallas/rnn.py:67"),
    # K1 at the eval CLIs' shapes (EVAL_SHAPES), on the 16-CTA forward and
    # the 8-CTA backward cluster bodies: the probe's B 8 / T 128 and Common
    # Voice's B 8 / T 900, the forward with residuals (train) and without
    # (inference)
    **{f"lstm_{d}_{cli}{mode}": (
        "cpc_audio_tpu_torch/csrc/" + ("rnn_cluster_fwd.cuh" if d == "fwd"
                                       else "lstm_bwd.cu"),
        "cpc_audio_tpu/ops/pallas/rnn.py:" + ("67" if d == "fwd" else "97"))
       for cli in ("probe", "cv") for d, mode in (("fwd", ""),
                                                  ("fwd", "_inference"),
                                                  ("bwd", ""))},
    # K1 and K4 at the variant paths' shapes (VARIANT_SHAPES): the LSTM
    # heads' K1 and the bidirectional ARs' K4 on their cluster bodies, the
    # learning gate's K4 forward on its resident body (also the
    # gru_fwd_resident entry), its backward on the rows body
    "lstm_fwd_heads": ("cpc_audio_tpu_torch/csrc/rnn_cluster_fwd.cuh",
                       "cpc_audio_tpu/ops/pallas/rnn.py:67"),
    "lstm_bwd_heads": ("cpc_audio_tpu_torch/csrc/lstm_bwd.cu",
                       "cpc_audio_tpu/ops/pallas/rnn.py:97"),
    "gru_fwd_bidir": ("cpc_audio_tpu_torch/csrc/rnn_cluster_fwd.cuh",
                      "cpc_audio_tpu/ops/pallas/rnn.py:238"),
    "gru_bwd_bidir": ("cpc_audio_tpu_torch/csrc/gru_bwd.cu",
                      "cpc_audio_tpu/ops/pallas/rnn.py:265"),
    "gru_fwd_gate": ("cpc_audio_tpu_torch/csrc/gru_fwd.cu",
                     "cpc_audio_tpu/ops/pallas/rnn.py:238"),
    "gru_fwd_resident": ("cpc_audio_tpu_torch/csrc/gru_fwd.cu",
                         "cpc_audio_tpu/ops/pallas/rnn.py:238"),
    "gru_bwd_gate": ("cpc_audio_tpu_torch/csrc/gru_bwd.cu",
                     "cpc_audio_tpu/ops/pallas/rnn.py:265"),
    # the long-window and wide shapes (phase_long_and_wide): K2's
    # tensor-core body at the heads' S 4084 (--sizeWindow 655360), at dk
    # 512 (--hiddenEncoder 4096) and at S 3700 / dk 264 (its DKP-512
    # kernels at a long window; their launches are the 4096 path's), and
    # its cluster body past dk 512 (--hiddenEncoder 4160, dk 520), K5 at S
    # 4096 and dk 512, K1's and K4's grid bodies at --hiddenGar 8192
    "relpos_attention_fwd_s4084": (
        "cpc_audio_tpu_torch/csrc/relpos_attention_tc_fwd.cu",
        "cpc_audio_tpu/ops/pallas/head_attention.py:114"),
    "relpos_attention_bwd_s4084": (
        "cpc_audio_tpu_torch/csrc/relpos_attention_tc_bwd.cu",
        "cpc_audio_tpu/ops/pallas/head_attention.py:158"),
    **{f"relpos_attention_{d}_{tag}": (
        f"cpc_audio_tpu_torch/csrc/relpos_attention_tc_{d}.cu",
        "cpc_audio_tpu/ops/pallas/head_attention.py:" + ("114" if d == "fwd"
                                                        else "158"))
       for tag in ("dk512", "s3700") for d in ("fwd", "bwd")},
    **{f"relpos_attention_{d}_cluster": (
        f"cpc_audio_tpu_torch/csrc/relpos_attention_tc_{d}.cu",
        "cpc_audio_tpu/ops/pallas/head_attention.py:" + ("114" if d == "fwd"
                                                        else "158"))
       for d in ("fwd", "bwd")},
    **{f"causal_attention_{d}_{tag}": (
        f"cpc_audio_tpu_torch/csrc/causal_attention_{d}.cu",
        "cpc_audio_tpu/ops/pallas/attention.py:" + ("81" if d == "fwd"
                                                    else "96"))
       for tag in ("s4096", "dk512") for d in ("fwd", "bwd")},
    **{f"{kind}_{d}_h8192": (
        "cpc_audio_tpu_torch/csrc/rnn_grid.cuh",
        "cpc_audio_tpu/ops/pallas/rnn.py:" + {
            ("lstm", "fwd"): "67", ("lstm", "bwd"): "97",
            ("gru", "fwd"): "238", ("gru", "bwd"): "265"}[(kind, d)])
       for kind in ("lstm", "gru") for d in ("fwd", "bwd")},
}

# The train path runs K2, K3, K5 and K6 at dropout 0.1: the JSON line
# reports each kernel in bf16 at the rate the train step gives it.
TRAIN_RATE = {"lstm_fwd": 0.0, "lstm_bwd": 0.0, "gru_fwd": 0.0,
              "gru_bwd": 0.0, "conv_ln_fwd": 0.0, "conv_ln_bwd": 0.0,
              "scatter_add_rows": 0.0, "scatter_add_rows_skewed": 0.0}

# H100 SXM peaks (NVIDIA's data sheet; dense, at 700 W): device memory
# bytes/s, and operations/s by input type (bf16 on the tensor cores,
# float32 outside them)
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# K3 in float32 runs its products as bf16 tensor-core products of split
# operands: G1 of 6, the others of 3 (the forward's two: 9 for 2; the
# backward's six: 21 for 6); K5 and K2 in float32 every product of 6 in
# the forward (three planes) and of 3 in the backward (two); K6's forward
# every product of 6 (its backward's mix is set in kernel_cases); K7's
# conv of 6 in the forward, dx and dW of 3 in the backward
SPLIT_PRODUCTS = {"relpos_attention_fwd": 6, "relpos_attention_bwd": 3,
                  "layer_tail_fwd": 9 / 2, "layer_tail_bwd": 21 / 6,
                  "causal_attention_fwd": 6, "causal_attention_bwd": 3,
                  "attention_block_fwd": 6, "conv_ln_fwd": 6,
                  "conv_ln_bwd": 3}


def _tensors(x):
    return [t for t in (x if isinstance(x, tuple) else (x,))
            if isinstance(t, torch.Tensor)]


def recurrent_split(case: Case, dtype: torch.dtype):
    """The bf16 products a float32 product of K1 or K4 takes on the body
    the case runs: 3 (h or dgates as bf16 hi + lo against W_hh's two bf16
    planes) on the cluster and grid bodies, None (exact float32 FMAs) on
    the rows and resident bodies and the 8-CTA backward at H <= 256."""
    body = recurrent_body(case, dtype)
    if body is None or body in ("rows", "resident"):
        return None
    H = case.inputs[W_HH_AT[case.name]].shape[1]
    if case.name.endswith("_bwd") and body == "cluster" and H <= 256:
        return None
    return 3


def bound(case: Case, out, dtype: torch.dtype) -> dict:
    """The least time the card could take for the call: each input byte
    it needs read once and each output written once at the memory rate,
    or its operations at the peak rate of its type, whichever is larger.
    A float32 body on split operands (``case.split``, or
    :func:`recurrent_split`) does its operations as that many times as
    many bf16 ones, at the bf16 peak (``split``); ``fp32_ms`` keeps the
    float32-core figure beside it."""
    read = case.read_bytes if case.read_bytes is not None else sum(
        t.numel() * t.element_size() for t in _tensors(case.inputs))
    nbytes = read + sum(t.numel() * t.element_size() for t in _tensors(out))
    t_bytes = nbytes / PEAK_BYTES * 1e3
    flops, peak = case.flops, PEAK_FLOPS[dtype]
    split = dtype == torch.float32 and (case.split or
                                        recurrent_split(case, dtype))
    if split:
        flops, peak = case.flops * split, PEAK_FLOPS[torch.bfloat16]
    t_ops = flops / peak * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops, "split": bool(split),
            "fp32_ms": case.flops / PEAK_FLOPS[torch.float32] * 1e3}


def library_calls(dev: torch.device, dtype: torch.dtype, B: int = 32):
    """{kernel: (call, what)} of one PyTorch call computing the same
    function as the kernel, timed as a yardstick only (the port never
    calls them).  K1/K4: the cuDNN layer on its input x (B, T, 256), whose
    backward also forms dW; K5: scaled_dot_product_attention with the
    bias as a float mask, at rate 0; K8: index_add_ into float32 zeros.
    K2 and K3 have none: no single call applies the rel-pos skew, or LN ->
    FFN -> residual -> LN."""
    g = torch.Generator(device=dev).manual_seed(SEED + 7)

    def rand(*shape, scale=1.0, grad=False):
        t = (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)
        return t.requires_grad_(grad)

    calls = {}
    for kind in ("lstm", "gru"):
        fwd, bwd, cls = cudnn_layer(dev, dtype, kind, g, B)
        calls[f"{kind}_fwd"] = (fwd, f"cuDNN nn.{cls} forward (training), "
                                     f"input projection included")
        calls[f"{kind}_bwd"] = (bwd, f"autograd backward of cuDNN nn.{cls}, "
                                     f"dx and dW")
    sdpa = sdpa_calls(rand, B, 32)
    calls["causal_attention_fwd"] = (
        sdpa[0], "F.scaled_dot_product_attention, float mask bias/sqrt(dk) "
        "with -inf above the diagonal, rate 0")
    calls["causal_attention_bwd"] = (
        sdpa[1], "autograd backward of that call: dq, dk, dv, dmask, rate 0")
    upd, keys, _, _, R = scatter_inputs(dev, dtype, B)
    calls["scatter_add_rows"] = (
        lambda: torch.zeros(R, upd.shape[1], device=dev).index_add_(
            0, keys, upd.float()),
        "torch.zeros(R, C).index_add_(0, keys, updates.float()), float32 "
        "atomics")
    return calls


def sdpa_calls(rand, B: int, dk: int, S: int = 128, nh: int = 8):
    """SDPA on (B, nh, S, dk) with the bias as a float mask (-inf above the
    diagonal), rate 0: (forward call, backward call forming dq, dk, dv and
    dmask), timed as a yardstick only.  rand(*shape, scale, grad)."""
    import torch.nn.functional as F
    q, k, v = (rand(B, nh, S, dk, grad=True) for _ in range(3))
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    mask = (rand(B, nh, S, S, scale=0.5) / dk ** 0.5).masked_fill(
        ~causal, float("-inf")).requires_grad_(True)
    o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    do = rand(B, nh, S, dk, scale=0.1)
    qd, kd, vd, md = (t.detach() for t in (q, k, v, mask))
    return (lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=md),
            lambda: torch.autograd.grad(o, [q, k, v, mask], do,
                                        retain_graph=True))


def wide_yardsticks(dev: torch.device, shaped: dict, B: int = 32) -> None:
    """The one-call yardsticks at the wider paths' shapes, bf16: cuDNN's
    nn.LSTM at B 8, T 256, H 512 (the long-window path's K1), at B 32,
    T 128, H 512 and at B 32, T 128, H 768 (the 768-wide path's), forward
    and backward (dx and dW too), each in turns with K1 there (K1,
    cuDNN, cuDNN, K1; the 16-CTA cluster bodies); SDPA at dk 64 (the
    512-wide transformer's K5: N = B * 8 rows of S 128), rate 0, beside
    K5 at rate 0, in turns (K5, SDPA, SDPA, K5)."""
    from cpc_audio_tpu_torch.ops import causal_attention as ca
    from cpc_audio_tpu_torch.ops import lstm
    g = torch.Generator(device=dev).manual_seed(SEED + 13)

    def rand(*shape, scale=1.0, grad=False):
        t = (torch.randn(shape, generator=g, device=dev) * scale).bfloat16()
        return t.requires_grad_(grad)
    for Bl, T, H in ((8, 256, 512), (32, 128, 512), (32, 128, 768)):
        tag = f"B {Bl} / T {T} / H {H}"
        cudnn = cudnn_layer(dev, torch.bfloat16, "lstm", g, B=Bl, T=T, C=H)
        fa, ba = recurrent_args(rand, dev, Bl, T, H)[:2]
        k1 = (lambda: lstm.lstm_fwd(*fa, save_residuals=True),
              lambda: lstm.lstm_bwd(*ba))
        bodies = (lstm.fwd_body(H, torch.bfloat16),
                  lstm.bwd_body(H, torch.bfloat16))
        for i, (name, what) in enumerate((
                ("lstm_fwd", "forward (training), input projection "
                             "included"),
                ("lstm_bwd", "autograd backward, dx and dW"))):
            t = {"kernel": [], "cudnn": []}
            for who in ("kernel", "cudnn", "cudnn", "kernel"):
                t[who].append(median_ms(k1[i] if who == "kernel"
                                        else cudnn[i]))
            k_ms, c_ms = (statistics.mean(t[w]) for w in ("kernel", "cudnn"))
            case = shaped.get((name, tag))
            print(f"  {name} {tag}, in turns ({bodies[i]} body): kernel "
                  f"{t['kernel'][0]:.4f} / {t['kernel'][1]:.4f} ms, cuDNN "
                  f"nn.{cudnn[2]} {what} {t['cudnn'][0]:.4f} / "
                  f"{t['cudnn'][1]:.4f} ms; kernel / cuDNN {k_ms / c_ms:.3f}"
                  + (f"; kernel in the case run {case:.4f} ms"
                     if case is not None else ""), flush=True)
        del fa, ba, k1, cudnn
        torch.cuda.empty_cache()
    N, S, dk = B * 8, 128, 64
    q, k, v = (rand(N, S, dk) for _ in range(3))
    bias, do = rand(N, S, S, scale=0.5), rand(N, S, dk, scale=0.1)
    k5 = (lambda: ca.causal_attention_fwd(q, k, v, bias),
          lambda: ca.causal_attention_bwd(q, k, v, bias, do))
    sdpa = sdpa_calls(rand, B, dk)
    for i, name in enumerate(("causal_attention_fwd",
                              "causal_attention_bwd")):
        t = {"K5": [], "SDPA": []}
        for who in ("K5", "SDPA", "SDPA", "K5"):
            t[who].append(median_ms(k5[i] if who == "K5" else sdpa[i]))
        print(f"  {name} dk 64 (N {N}, S {S}), rate 0, in turns: K5 "
              f"{t['K5'][0]:.4f} / {t['K5'][1]:.4f} ms, SDPA "
              f"{t['SDPA'][0]:.4f} / {t['SDPA'][1]:.4f} ms; K5 / SDPA "
              f"{statistics.mean(t['K5']) / statistics.mean(t['SDPA']):.3f}"
              f"; K5 at rate 0.1 {shaped[(name, 'dk 64 / D 512')]:.4f} ms",
              flush=True)


def f32_yardsticks(dev: torch.device, B: int = 32) -> None:
    """The one-call yardsticks in float32 (TF32 off, the package's policy)
    beside the float32 bodies, in turns (kernel, library, library,
    kernel): cuDNN's nn.LSTM at K1's shapes (B 32 / T 128 / H 256, B 8 /
    T 256 / H 512, B 32 / T 128 / H 512, B 32 / T 128 / H 768) and nn.GRU
    at K4's (B 32 / T 128 / H 256), forward and backward (dx and dW too);
    SDPA at K5's (N = B * 8 rows of S 128, dk 32 and 64; N = 32 rows at
    dk 256, the --hiddenEncoder 2048 path's), rate 0."""
    from cpc_audio_tpu_torch.ops import causal_attention as ca
    from cpc_audio_tpu_torch.ops import gru, lstm
    f32 = torch.float32
    g = torch.Generator(device=dev).manual_seed(SEED + 17)

    def rand(*shape, scale=1.0, grad=False):
        t = torch.randn(shape, generator=g, device=dev) * scale
        return t.requires_grad_(grad)

    def turns(label: str, kernel, library, what: str) -> None:
        t = {"kernel": [], "library": []}
        for who in ("kernel", "library", "library", "kernel"):
            t[who].append(median_ms(kernel if who == "kernel" else library))
        k_ms, l_ms = (statistics.mean(t[w]) for w in ("kernel", "library"))
        print(f"  {label}, float32, in turns: kernel {t['kernel'][0]:.4f} / "
              f"{t['kernel'][1]:.4f} ms, {what} {t['library'][0]:.4f} / "
              f"{t['library'][1]:.4f} ms; kernel / library "
              f"{k_ms / l_ms:.3f}", flush=True)

    for kind, Bl, T, H in (("lstm", B, 128, 256), ("lstm", 8, 256, 512),
                           ("lstm", B, 128, 512), ("lstm", B, 128, 768),
                           ("gru", B, 128, 256)):
        cudnn = cudnn_layer(dev, f32, kind, g, B=Bl, T=T, C=H)
        la, lba, ga, gba = recurrent_args(rand, dev, Bl, T, H)
        k = ((lambda: lstm.lstm_fwd(*la, save_residuals=True),
              lambda: lstm.lstm_bwd(*lba)) if kind == "lstm" else
             (lambda: gru.gru_fwd(*ga, save_residuals=True),
              lambda: gru.gru_bwd(*gba)))
        mod = lstm if kind == "lstm" else gru
        bodies = (mod.fwd_body(H, f32), mod.bwd_body(H, f32))
        for i, d in enumerate(("fwd", "bwd")):
            turns(f"{kind}_{d} B {Bl} / T {T} / H {H} ({bodies[i]} body)",
                  k[i], cudnn[i],
                  f"cuDNN nn.{cudnn[2]} " + ("forward (training), input "
                                             "projection included" if i == 0
                                             else "autograd backward, dx and "
                                             "dW"))
        del la, lba, ga, gba, k, cudnn
        torch.cuda.empty_cache()
    for dk, Bk in ((32, B), (64, B), (256, 4)):
        N, S = Bk * 8, 128
        q, k, v = (rand(N, S, dk) for _ in range(3))
        bias, do = rand(N, S, S, scale=0.5), rand(N, S, dk, scale=0.1)
        sdpa = sdpa_calls(rand, Bk, dk)
        for i, (name, call) in enumerate((
                ("causal_attention_fwd",
                 lambda: ca.causal_attention_fwd(q, k, v, bias)),
                ("causal_attention_bwd",
                 lambda: ca.causal_attention_bwd(q, k, v, bias, do)))):
            turns(f"{name} dk {dk} (N {N}, S {S}), rate 0", call, sdpa[i],
                  "SDPA" + ("" if i == 0 else " autograd backward"))


ROWS_SHAPES = (("lstm", 32, 1056), ("gru", 32, 512), ("gru", 32, 768))
H4096_SHAPES = (("lstm", 4, 4096), ("gru", 4, 4096))


def rows_yardsticks(dev: torch.device, shapes=ROWS_SHAPES, T: int = 128,
                    **timing) -> dict:
    """cuDNN beside the bodies that were the rows bodies until the grid
    bodies took them, in both dtypes, in turns (kernel, cuDNN, cuDNN,
    kernel): at ``shapes`` (kind, B, H), by default nn.LSTM at H 1056
    (--hiddenGar 1056: K1's grid bodies) and nn.GRU at H 512 and 768
    (K4's) at B 32, forward (training, input projection included) and
    backward (dx and dW too), T 128; ``timing`` goes to median_ms (fewer
    calls at H 4096).  Returns cuDNN's mean ms by (kernel, B, H, dtype)."""
    from cpc_audio_tpu_torch.ops import gru, lstm
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        g = torch.Generator(device=dev).manual_seed(SEED + 19)

        def rand(*shape, scale=1.0):
            return (torch.randn(shape, generator=g, device=dev)
                    * scale).to(dtype)
        for kind, B, H in shapes:
            cudnn = cudnn_layer(dev, dtype, kind, g, B=B, T=T, C=H)
            la, lba, ga, gba = recurrent_args(rand, dev, B, T, H)
            k = ((lambda: lstm.lstm_fwd(*la, save_residuals=True),
                  lambda: lstm.lstm_bwd(*lba)) if kind == "lstm" else
                 (lambda: gru.gru_fwd(*ga, save_residuals=True),
                  lambda: gru.gru_bwd(*gba)))
            mod = lstm if kind == "lstm" else gru
            bodies = (mod.fwd_body(H, dtype), mod.bwd_body(H, dtype))
            args = (la, lba) if kind == "lstm" else (ga, gba)
            G = 4 if kind == "lstm" else 3
            for i, d in enumerate(("fwd", "bwd")):
                b = bound(Case(f"{kind}_{d}", 0.0, k[i], None, args[i],
                               2 * B * T * G * H * H), k[i](), dtype)
                t = {"kernel": [], "cudnn": []}
                for who in ("kernel", "cudnn", "cudnn", "kernel"):
                    t[who].append(median_ms(k[i] if who == "kernel"
                                            else cudnn[i], **timing))
                k_ms, c_ms = (statistics.mean(t[w])
                              for w in ("kernel", "cudnn"))
                out[(f"{kind}_{d}", B, H, dtype)] = c_ms
                print(f"  {kind}_{d} B {B} / T {T} / H {H}, "
                      f"{str(dtype)[6:]}, in turns ({bodies[i]} body): "
                      f"kernel {t['kernel'][0]:.4f} / {t['kernel'][1]:.4f} "
                      f"ms, cuDNN nn.{cudnn[2]} "
                      + ("forward (training), input projection included"
                         if i == 0 else "autograd backward, dx and dW")
                      + f" {t['cudnn'][0]:.4f} / {t['cudnn'][1]:.4f} ms; "
                      f"kernel / cuDNN {k_ms / c_ms:.3f}; kernel bound "
                      f"{b['bound_ms']:.4f} ms by {b['bound_by']}",
                      flush=True)
            del la, lba, ga, gba, k, cudnn
            torch.cuda.empty_cache()
    return out


def features_yardstick(dev: torch.device, B: int = 8, T: int = 400,
                       H: int = 256) -> float:
    """K1's inference forward at build_features_batched's shape beside
    cuDNN's nn.LSTM forward under inference_mode (input projection
    included) from the same non-zero state, in both dtypes, in turns
    (kernel, cuDNN, cuDNN, kernel).  Returns cuDNN's bf16 mean ms."""
    from cpc_audio_tpu_torch.ops import lstm
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        g = torch.Generator(device=dev).manual_seed(SEED + 29)

        def rand(*shape, scale=1.0):
            return (torch.randn(shape, generator=g, device=dev)
                    * scale).to(dtype)
        la = features_args(rand, B, T, H)
        layer = torch.nn.LSTM(H, H, batch_first=True).to(dev, dtype)
        layer.flatten_parameters()
        x = rand(B, T, H)
        h0, c0 = (t.unsqueeze(0) for t in la[2:])

        def cudnn():
            with torch.inference_mode():
                return layer(x, (h0, c0))

        def kernel():
            return lstm.lstm_fwd(*la)
        b = bound(Case("lstm_fwd", 0.0, kernel, None, la,
                       2 * B * T * 4 * H * H), kernel(), dtype)
        t = {"kernel": [], "cudnn": []}
        for who in ("kernel", "cudnn", "cudnn", "kernel"):
            t[who].append(median_ms(kernel if who == "kernel" else cudnn))
        k_ms, c_ms = (statistics.mean(t[w]) for w in ("kernel", "cudnn"))
        out[dtype] = c_ms
        print(f"  lstm_fwd inference B {B} / T {T} / H {H}, "
              f"{str(dtype)[6:]}, in turns ({lstm.fwd_body(H, dtype)} "
              f"body): kernel {t['kernel'][0]:.4f} / {t['kernel'][1]:.4f} "
              f"ms, cuDNN nn.LSTM forward under inference_mode, input "
              f"projection included {t['cudnn'][0]:.4f} / "
              f"{t['cudnn'][1]:.4f} ms; kernel / cuDNN {k_ms / c_ms:.3f}; "
              f"kernel bound {b['bound_ms']:.4f} ms by {b['bound_by']} "
              f"({b['bytes'] / 1e6:.2f} MB)", flush=True)
        del layer, x, la
        torch.cuda.empty_cache()
    return out[torch.bfloat16]


def long_causal_yardsticks(dev: torch.device, B: int = 4, S: int = 1024,
                           dk: int = 32) -> dict:
    """SDPA beside K5 at --sizeWindow 163840's shape (N = B * 8 rows of S
    1024, dk 32; or the (S, dk) given), rate 0, both dtypes, in turns (K5,
    SDPA, SDPA, K5), forward and backward, each with K5's bound.  Returns
    SDPA's mean ms by (kernel, dtype)."""
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        g = torch.Generator(device=dev).manual_seed(SEED + 23)

        def rand(*shape, scale=1.0, grad=False):
            t = (torch.randn(shape, generator=g, device=dev)
                 * scale).to(dtype)
            return t.requires_grad_(grad)
        N = B * 8
        cases = causal_cases(rand, None, N, S, dk, f"S {S} / dk {dk}",
                             rate=0.0)
        sdpa = sdpa_calls(rand, B, dk, S=S)
        for i, case in enumerate(cases):
            b = bound(case, case.kernel(), dtype)
            t = {"K5": [], "SDPA": []}
            for who in ("K5", "SDPA", "SDPA", "K5"):
                t[who].append(median_ms(case.kernel if who == "K5"
                                        else sdpa[i]))
            print(f"  {case.name} N {N} / S {S} / dk {dk}, "
                  f"{str(dtype)[6:]}, rate 0, in turns: K5 "
                  f"{t['K5'][0]:.4f} / {t['K5'][1]:.4f} ms, SDPA"
                  + ("" if i == 0 else " autograd backward")
                  + f" {t['SDPA'][0]:.4f} / {t['SDPA'][1]:.4f} ms; K5 / "
                  f"SDPA {statistics.mean(t['K5']) / statistics.mean(t['SDPA']):.3f}"
                  f"; K5 bound {b['bound_ms']:.4f} ms by {b['bound_by']}",
                  flush=True)
            out[(case.name, dtype)] = statistics.mean(t["SDPA"])
        del cases, sdpa
        torch.cuda.empty_cache()
    return out


def cudnn_layer(dev: torch.device, dtype: torch.dtype, kind: str,
                g: torch.Generator, B: int = 32, T: int = 128, C: int = 256):
    """cuDNN's whole one-layer nn.LSTM / nn.GRU ("lstm" / "gru") on x (B,
    T, C) in ``dtype``: (forward call, backward call forming dx and dW,
    class name), timed as a yardstick only."""
    cls = torch.nn.LSTM if kind == "lstm" else torch.nn.GRU
    layer = cls(C, C, batch_first=True).to(dev, dtype)
    layer.flatten_parameters()           # one weight buffer, as cuDNN wants
    x = (torch.randn((B, T, C), generator=g, device=dev)).to(dtype) \
        .requires_grad_(True)
    y, _ = layer(x)
    dy = (torch.randn((B, T, C), generator=g, device=dev) * 0.1).to(dtype)
    leaves = [x] + list(layer.parameters())
    return (lambda: layer(x),
            lambda: torch.autograd.grad(y, leaves, dy, retain_graph=True),
            cls.__name__)


def recurrent_against_cudnn(dev: torch.device, B: int = 32) -> None:
    """K1's and K4's backward beside cuDNN's whole layer backward (which
    also forms dx and dW), in bf16 and float32, in one call and in turns
    (kernel, cuDNN, cuDNN, kernel; device time a call, median_ms); then
    the port's whole recurrent layer (F.linear + K1/K4, autograd with dW)
    beside cuDNN's layer, forward and backward, in turns."""
    from cpc_audio_tpu_torch.models.ar import CPCAR
    from cpc_audio_tpu_torch.ops import gru, lstm
    for dtype in (torch.bfloat16, torch.float32):
        g = torch.Generator(device=dev).manual_seed(SEED + 11)

        def rand(*shape, scale=1.0):
            return (torch.randn(shape, generator=g, device=dev)
                    * scale).to(dtype)
        _, lstm_bwd_args, _, gru_bwd_args = recurrent_args(rand, dev, B)
        for kind, kernel, args, mod in (
                ("lstm", lstm.lstm_bwd, lstm_bwd_args, lstm),
                ("gru", gru.gru_bwd, gru_bwd_args, gru)):
            _, cudnn_bwd, cls = cudnn_layer(dev, dtype, kind, g, B)
            t = {"kernel": [], "cudnn": []}
            for who in ("kernel", "cudnn", "cudnn", "kernel"):
                t[who].append(median_ms(
                    (lambda: kernel(*args)) if who == "kernel" else cudnn_bwd))
            k_ms, c_ms = (statistics.mean(t[w]) for w in ("kernel", "cudnn"))
            print(f"  {kind}_bwd vs cuDNN, {str(dtype)[6:]}, in turns "
                  f"(B {B}, T 128, H 256; {mod.bwd_body(256, dtype)} body): "
                  f"kernel {t['kernel'][0]:.4f} / {t['kernel'][1]:.4f} ms, "
                  f"cuDNN nn.{cls} backward {t['cudnn'][0]:.4f} / "
                  f"{t['cudnn'][1]:.4f} ms; kernel / cuDNN {k_ms / c_ms:.3f}",
                  flush=True)
        torch.cuda.empty_cache()
    g = torch.Generator(device=dev).manual_seed(SEED + 12)
    x = torch.randn((B, 128, 256), generator=g, device=dev).to(
        torch.bfloat16).requires_grad_(True)
    for mode in ("LSTM", "GRU"):
        ar = CPCAR(256, 256, 1, mode).to(dev)
        y, _ = ar(x)
        dy = torch.randn_like(y) * 0.1
        leaves = [x] + list(ar.parameters())
        port = (lambda: ar(x), lambda: torch.autograd.grad(
            y, leaves, dy, retain_graph=True))
        cudnn = cudnn_layer(dev, torch.bfloat16, mode.lower(), g, B)
        t = {"port": [[], []], "cudnn": [[], []]}
        for who in ("port", "cudnn", "cudnn", "port"):
            calls = port if who == "port" else cudnn
            for i in (0, 1):
                t[who][i].append(median_ms(calls[i]))
        print(f"  port {mode} layer (F.linear + kernel, autograd with dW) vs "
              f"cuDNN nn.{cudnn[2]}, bf16, B {B}, T 128, 256 -> 256, in "
              f"turns: forward port {t['port'][0][0]:.4f} / "
              f"{t['port'][0][1]:.4f} ms, cuDNN {t['cudnn'][0][0]:.4f} / "
              f"{t['cudnn'][0][1]:.4f} ms; backward port "
              f"{t['port'][1][0]:.4f} / {t['port'][1][1]:.4f} ms, cuDNN "
              f"{t['cudnn'][1][0]:.4f} / {t['cudnn'][1][1]:.4f} ms",
              flush=True)


# kernel-name fragments (lower case) of the launches of K3's forward and
# backward (in float32 also the split of the weights into bf16 planes)
TAIL_FWD_LAUNCHES = (("split", "tail_split_kernel"),
                     ("LN1", "tail_ln1_kernel"), ("G1", "g1_hidden"),
                     ("G2", "g2_out"))
TAIL_BWD_LAUNCHES = (("split", "tail_split_kernel"),
                     ("LN1", "tail_ln1_kernel"), ("G1", "g1_hidden"),
                     ("G2", "g2_ln2"), ("G3", "g3_dhp"), ("G4", "g4_dx"),
                     ("G5", "g5_dw1"), ("G6", "g6_dw2"),
                     ("sums", "sum_parts"))
TAIL_LAUNCHES = {"layer_tail_fwd": TAIL_FWD_LAUNCHES,
                 "layer_tail_bwd": TAIL_BWD_LAUNCHES}
# past D 1024 the wide body: G2 and G4 on 128 x 128 tiles, LN2 (and the
# backward's LN2' and LN1') in row and column passes
TAIL_WIDE_LAUNCHES = {
    "layer_tail_fwd": (("split", "tail_split_kernel"),
                       ("LN1", "tail_ln1_wide_kernel"), ("G1", "g1_hidden"),
                       ("G2", "g2_wide"), ("LN2", "tail_ln2_out_kernel")),
    "layer_tail_bwd": (("split", "tail_split_kernel"),
                       ("LN1", "tail_ln1_wide_kernel"), ("G1", "g1_hidden"),
                       ("G2", "g2_wide"), ("G3", "g3_dhp"),
                       ("G4", "g4_wide"), ("row passes", "tail_rows_kernel"),
                       ("column passes", "tail_cols_kernel"),
                       ("G5", "g5_dw1"), ("G6", "g6_dw2"),
                       ("sums", "sum_parts"))}
# K6's launches: its GEMMs (csrc/attention_block_tc.cuh; in float32 also
# the split into bf16 planes) and the kernels of K2's tensor-core body it
# runs through K2's C entry points (krel's padded planes and, in float32,
# the operands' planes first)
BLOCK_LAUNCHES = {
    "attention_block_fwd": (("split", "k6::split_kernel"),
                            ("Proj", "k6::proj<"), ("K2 copies", "planes<"),
                            ("K2 forward", "relpos_tc_fwd"),
                            ("Out", "k6::out<")),
    "attention_block_bwd": (("split", "k6::split_kernel"),
                            ("Dy", "k6::dy<"), ("K2 copies", "planes<"),
                            ("K2 rows", "relpos_tc_bwd_rows"),
                            ("K2 columns", "relpos_tc_bwd_cols"),
                            ("K2 diagonals", "relpos_tc_bwd_diag"),
                            ("K2 windows' sum", "dkrel_windows_reduce"),
                            ("DW", "k6::dw<"), ("Dcp", "k6::dcp<"))}
# K7's launches (csrc/conv_ln.cuh), over the four layers of a call: in
# float32 the split of x and w into bf16 planes first; the forward's GEMM
# with the norm in its epilogue; the backward's rows pass, Dx, DW and the
# fixed-order sums of the vectors' and dW's parts
CONV_LAUNCHES = {
    "conv_ln_fwd": (("split", "conv_ln::split_kernel"),
                    ("Fwd", "conv_ln::fwd_kernel")),
    "conv_ln_bwd": (("split", "conv_ln::split_kernel"),
                    ("rows", "conv_ln::rows_kernel"),
                    ("Dx", "conv_ln::dx_kernel"),
                    ("DW", "conv_ln::dw_kernel"),
                    ("sums", "sum_parts"))}


def rerun_and_launches(case: Case, ms: float, dtype: torch.dtype,
                       n: int = 3) -> None:
    """K3's, K6's or K7's forward or backward: a rerun must be
    bit-identical to
    the first call (no atomics, fixed-order sums); then the device time of
    each of its launches over ``n`` calls (torch.profiler), beside the
    call's median_ms: ``TAIL_LAUNCHES`` (in float32 the split of the
    weights, LN1, the forward's two GEMMs or the backward's six and the
    fixed-order sums over tiles), ``BLOCK_LAUNCHES`` or
    ``CONV_LAUNCHES``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    first, again = _tensors(case.kernel()), _tensors(case.kernel())
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, again)):
        fail(f"{case.label}: a rerun is not bit-identical")
    del first, again
    from cpc_audio_tpu_torch.ops import ffn
    wide = case.inputs[0].shape[-1] > ffn.ROW_TILE_MAX_D
    launches = BLOCK_LAUNCHES.get(case.name) or \
        CONV_LAUNCHES.get(case.name) or (
            TAIL_WIDE_LAUNCHES if wide else TAIL_LAUNCHES)[case.name]
    # torch.profiler now and then returns a profile without the device's
    # events (none at all, after its warning that "Profiler clears events
    # at the end of each cycle"), on an H100 once three times running (a
    # float32 K3 forward); profile again, up to six times, a second apart,
    # before calling a launch missing
    for attempt in range(6):
        if attempt:
            time.sleep(1.0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                case.kernel()
            torch.cuda.synchronize()
        t = {use: 0.0 for use, _ in launches
             if use != "split" or dtype == torch.float32}
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            use = next((u for u, frag in launches
                        if frag in e.key.lower() and u in t), None)
            if use is not None:
                t[use] += e.self_device_time_total / 1e3 / n
        missing = [use for use, v in t.items() if v == 0.0]
        if not missing:
            break
    if missing:
        fail(f"{case.label}: the profile shows no {', '.join(missing)}")
    print(f"  {case.label}: reruns bit-identical; device ms a call by "
          f"launch (torch.profiler, {n} calls): " + ", ".join(
              f"{use} {v:.4f}" for use, v in t.items()) +
          f"; sum {sum(t.values()):.4f}, median_ms {ms:.4f}", flush=True)


def recurrent_rerun(case: Case, body: str) -> None:
    """A K1 / K4 case's body; on the cluster, grid and resident bodies a
    rerun must be bit-identical to the first call (fixed-order sums, no
    atomics on values)."""
    line = f"  {case.label}: {body} body"
    if body in ("cluster", "grid", "resident"):
        first, again = _tensors(case.kernel()), _tensors(case.kernel())
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(first, again)):
            fail(f"{case.label}: a rerun of the {body} body is not "
                 f"bit-identical")
        line += ", a rerun bit-identical"
    print(line, flush=True)


def phase_kernels(dev: torch.device, B: int = 32) -> dict:
    results, rate0, shaped = {}, {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        print(f"kernels vs plain versions, {str(dtype)[6:]}:", flush=True)
        for case in kernel_cases(dev, dtype, B):
            name = case.name
            got = case.kernel()
            want = case.plain()
            torch.cuda.synchronize()
            label = case.label
            b = bound(case, got, dtype)
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
            # the plain version is timed where its time is reported: bf16
            # at the rate the train step gives the kernel
            reported = dtype == torch.bfloat16 and \
                case.rate == TRAIN_RATE.get(name, 0.1)
            ms = median_ms(case.kernel)
            plain_ms = median_ms(case.plain) if reported else None
            plain = f"{plain_ms:.4f} ms" if reported else "not timed"
            split = (f" as bf16 split products; on the float32 cores "
                     f"{b['fp32_ms']:.4f} ms" if b["split"] else "")
            print(f"  {label}: kernel {ms:.4f} ms, plain {plain} "
                  f"(device time a call, median of {REPS} runs of up to "
                  f"{CALLS}); "
                  f"bound {b['bound_ms']:.4f} ms by "
                  f"{b['bound_by']} ({b['bytes'] / 1e6:.2f} MB, "
                  f"{b['flops'] / 1e9:.3f} GFLOP{split}), "
                  f"{b['bound_ms'] / ms:.1%} of it", flush=True)
            if name.startswith("causal_attention") and case.shape is None \
                    and case.rate == 0.0 and dtype == torch.bfloat16:
                rate0[name] = ms
            if (name in TAIL_LAUNCHES or name in BLOCK_LAUNCHES
                    or name in CONV_LAUNCHES) and \
                    case.rate == TRAIN_RATE.get(name, 0.1):
                rerun_and_launches(case, ms, dtype)
            body = recurrent_body(case, dtype)
            if body is not None:
                recurrent_rerun(case, body)
            for shapes, own in ((GRID_SHAPES, "grid"),
                                (ROWS_FWD_SHAPES, "rows"),
                                (RESIDENT_FWD_SHAPES, "resident")):
                if body == own and reported and \
                        case.shape in [f"B {B} / T {T} / H {H}"
                                       for _, B, T, H in shapes]:
                    results[f"{name}_{own}"] = {
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": b["bound_ms"],
                        "bound_by": b["bound_by"], "library_ms": None}
            if name == "lstm_fwd" and reported and \
                    case.shape == FEATURES_SHAPE:
                results["lstm_fwd_features"] = {
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                    "library_ms": None}
            if reported and hasattr(case, "entry"):
                results[case.entry] = {
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                    "library_ms": None}
            if reported and case.shape is not None:
                shaped[(name, case.shape)] = ms
            if reported and case.shape is None:
                results[name] = {"max_abs_err": err, "ms": ms,
                                 "plain_ms": plain_ms,
                                 "bound_ms": b["bound_ms"],
                                 "bound_by": b["bound_by"],
                                 "library_ms": None}
        torch.cuda.empty_cache()
    print("yardsticks, bf16 (one PyTorch call computing the same function; "
          "the port never calls it):", flush=True)
    calls = library_calls(dev, torch.bfloat16, B)
    for name, (call, what) in calls.items():
        lib_ms = median_ms(call)
        results[name]["library_ms"] = lib_ms
        print(f"  {name}: {lib_ms:.4f} ms ({what}); kernel "
              f"{results[name]['ms']:.4f} ms", flush=True)
    causal_against_sdpa(dev, results, rate0, calls, B)
    wide_yardsticks(dev, shaped, B)
    f32_yardsticks(dev, B)
    for name in ("relpos_attention_fwd", "relpos_attention_bwd",
                 "layer_tail_fwd", "layer_tail_bwd", "attention_block_fwd",
                 "attention_block_bwd"):
        print(f"  {name}: none (no single call applies the rel-pos skew, "
              f"or LN -> FFN -> residual -> LN)", flush=True)
    for name in ("conv_ln_fwd", "conv_ln_bwd"):
        print(f"  {name}: none (no single call does conv + ChannelNorm + "
              f"ReLU; the composition is timed below)", flush=True)
    recurrent_against_cudnn(dev, B)
    cudnn_ms = rows_yardsticks(dev)
    for kind, B_, T, H in GRID_SHAPES:
        for d in ("fwd", "bwd"):
            results[f"{kind}_{d}_grid"]["library_ms"] = cudnn_ms[
                (f"{kind}_{d}", B_, H, torch.bfloat16)]
    cudnn_ms = rows_yardsticks(dev, [(k, B_, H)
                                     for k, B_, _, H in ROWS_FWD_SHAPES])
    for kind, B_, T, H in ROWS_FWD_SHAPES:
        results[f"{kind}_fwd_rows"]["library_ms"] = cudnn_ms[
            (f"{kind}_fwd", B_, H, torch.bfloat16)]
    rows_yardsticks(dev, H4096_SHAPES, warmup=1, reps=2)
    results["lstm_fwd_features"]["library_ms"] = features_yardstick(dev)
    for cli, B_, T, H in EVAL_SHAPES:
        results[f"lstm_fwd_{cli}_inference"]["library_ms"] = \
            features_yardstick(dev, B_, T, H)
        cudnn_ms = rows_yardsticks(dev, [("lstm", B_, H)], T=T)
        for d in ("fwd", "bwd"):
            results[f"lstm_{d}_{cli}"]["library_ms"] = cudnn_ms[
                (f"lstm_{d}", B_, H, torch.bfloat16)]
    for tag, kind, B_, T, H in VARIANT_SHAPES:
        cudnn_ms = rows_yardsticks(dev, [(kind, B_, H)], T=T)
        for d in ("fwd", "bwd"):
            results[f"{kind}_{d}_{tag}"]["library_ms"] = cudnn_ms[
                (f"{kind}_{d}", B_, H, torch.bfloat16)]
    for kind, B_, T, H in RESIDENT_FWD_SHAPES:
        results[f"{kind}_fwd_resident"]["library_ms"] = \
            results[f"{kind}_fwd_gate"]["library_ms"]
    long_causal_yardsticks(dev)
    conv_composition_times(dev, B)
    block_composition_times(dev, B)
    scatter_wrapper_times(dev, results, B)
    torch.cuda.empty_cache()
    return results


def causal_against_sdpa(dev: torch.device, results: dict, rate0: dict,
                        calls: dict, B: int = 32) -> None:
    """K5 at rate 0, SDPA's rate, beside SDPA (bf16, N 256, S 128, dk 32);
    then both again by the host-bound measure (host_bound_ms: events
    around one synchronised call), in the same call."""
    from cpc_audio_tpu_torch.ops import causal_attention as ca
    for name in ("causal_attention_fwd", "causal_attention_bwd"):
        print(f"  {name} at rate 0: K5 {rate0[name]:.4f} ms, SDPA "
              f"{results[name]['library_ms']:.4f} ms (device time a call); "
              f"K5 / SDPA {rate0[name] / results[name]['library_ms']:.3f}",
              flush=True)
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    N, S, dk = B * 8, 128, 32
    q, k, v = (torch.randn(N, S, dk, generator=g, device=dev).bfloat16()
               for _ in range(3))
    bias = (torch.randn(N, S, S, generator=g, device=dev) * 0.5).bfloat16()
    do = (torch.randn(N, S, dk, generator=g, device=dev) * 0.1).bfloat16()
    fwd = host_bound_ms(lambda: ca.causal_attention_fwd(q, k, v, bias))
    bwd = host_bound_ms(lambda: ca.causal_attention_bwd(q, k, v, bias, do))
    print(f"  host-bound measure (one synchronised call), rate 0: K5 "
          f"forward {fwd:.4f} "
          f"ms, SDPA {host_bound_ms(calls['causal_attention_fwd'][0]):.4f} "
          f"ms; K5 backward {bwd:.4f} ms, SDPA "
          f"{host_bound_ms(calls['causal_attention_bwd'][0]):.4f} ms",
          flush=True)


def scatter_wrapper_times(dev: torch.device, timings: dict,
                          B: int = 32) -> None:
    """scatter_add_rows as the exact sampler's backward calls it: a stable
    sort of the keys, searchsorted, K8 (bf16 and f32)."""
    from cpc_audio_tpu_torch.ops import scatter_add as sa
    for dtype in (torch.bfloat16, torch.float32):
        upd, keys, _, _, R = scatter_inputs(dev, dtype, B)
        sort_ms = median_ms(lambda: sa.sort_keys(keys, R))
        ms = median_ms(lambda: sa.scatter_add_rows(upd, keys, R))
        print(f"  scatter_add_rows wrapper, {str(dtype)[6:]}: sort + "
              f"searchsorted + K8 {ms:.4f} ms (sort + searchsorted alone "
              f"{sort_ms:.4f} ms); K8 alone, bf16: "
              f"{timings['scatter_add_rows']['ms']:.4f} ms; J = "
              f"{keys.shape[0]}, R = {R}", flush=True)
    # K8 on the global pool of RANKS ranks beside index_add_ (bf16
    # updates), in turns: the pool entry's yardstick
    upd, keys, order, offsets, R = scatter_inputs(dev, torch.bfloat16, B,
                                                  world=RANKS)
    t = {"K8": [], "index_add_": []}
    for who in ("K8", "index_add_", "index_add_", "K8"):
        t[who].append(median_ms(
            (lambda: sa.scatter_add_sorted(upd, order, offsets))
            if who == "K8" else
            (lambda: torch.zeros(R, upd.shape[1], device=dev).index_add_(
                0, keys, upd.float()))))
    timings["scatter_add_rows_pool"]["library_ms"] = \
        statistics.median(t["index_add_"])
    print(f"  scatter_add_rows bf16, the global pool (R {R}), in turns: K8 "
          f"{t['K8'][0]:.4f} / {t['K8'][1]:.4f} ms, index_add_ "
          f"{t['index_add_'][0]:.4f} / {t['index_add_'][1]:.4f} ms",
          flush=True)
    # K8 at the rows of --hiddenEncoder 200 and 1056 in float32 (rows past
    # 4096 bytes walked in pieces) beside index_add_, in turns
    for C in (200, 1056):
        upd, keys, order, offsets, R = scatter_inputs(dev, torch.float32, B,
                                                      C)
        t = {"K8": [], "index_add_": []}
        for who in ("K8", "index_add_", "index_add_", "K8"):
            t[who].append(median_ms(
                (lambda: sa.scatter_add_sorted(upd, order, offsets))
                if who == "K8" else
                (lambda: torch.zeros(R, C, device=dev).index_add_(
                    0, keys, upd))))
        print(f"  scatter_add_rows float32 C {C}, in turns: K8 "
              f"{t['K8'][0]:.4f} / {t['K8'][1]:.4f} ms, index_add_ "
              f"{t['index_add_'][0]:.4f} / {t['index_add_'][1]:.4f} ms",
              flush=True)


def conv_composition(layers, dys):
    """(forward, backward) of the port's unfused encoder layers 1-4 as it
    runs them by default (cuDNN F.conv1d, ChannelNorm and ReLU,
    channels-first, models/encoder.py), the backward by autograd with
    every weight's gradient; on K7's inputs (:func:`conv_layers`), in
    their dtype.  A composition of calls, not one call, so it is no
    library time."""
    import torch.nn.functional as F
    from cpc_audio_tpu_torch.models.norms import ChannelNorm
    dtype = layers[0][0].dtype
    norm = ChannelNorm(256).to(layers[0][0].device)
    leaves, outs = [], []
    for x, w, bias, _, _, s, k, p in layers:
        xc = x.transpose(1, 2).contiguous().requires_grad_(True)
        wc = w.reshape(k, 256, 256).permute(2, 1, 0).contiguous() \
            .requires_grad_(True)
        bc = bias.to(dtype).requires_grad_(True)
        leaves.append((xc, wc, bc))
        outs.append(lambda xc=xc, wc=wc, bc=bc, s=s, p=p: torch.relu(
            norm(F.conv1d(xc, wc, bc, stride=s, padding=p))))
    ys = [f() for f in outs]
    cts = [dy.transpose(1, 2) for dy in dys]
    return (lambda: [f() for f in outs],
            lambda: [torch.autograd.grad(y, list(lv) + list(
                norm.parameters()), ct, retain_graph=True)
                for y, lv, ct in zip(ys, leaves, cts)])


def conv_composition_times(dev: torch.device, B: int = 32) -> None:
    """K7 beside the unfused composition (:func:`conv_composition`) on
    encoder layers 1-4 at the default train shapes, in both dtypes (float32
    under the port's precision policy: TF32 off for cuDNN's convolutions)
    and directions, in turns (K7, composition, composition, K7), device
    time a call."""
    from cpc_audio_tpu_torch.ops import conv_ln as cl
    for dtype in (torch.bfloat16, torch.float32):
        g = torch.Generator(device=dev).manual_seed(SEED + 8)

        def rand(*shape, scale=1.0, dt=dtype):
            return (torch.randn(shape, generator=g, device=dev)
                    * scale).to(dt)

        layers, dys = conv_layers(rand, B)
        saved = [cl.conv_ln_relu_fwd(*l)[1] for l in layers]
        k7 = (lambda: [cl.conv_ln_relu_fwd(*l)[0] for l in layers],
              lambda: [cl.conv_ln_relu_bwd(*l[:5], dy, sv, *l[5:])
                       for l, dy, sv in zip(layers, dys, saved)])
        comp = conv_composition(layers, dys)
        t = {"K7": [[], []], "composition": [[], []]}
        for who in ("K7", "composition", "composition", "K7"):
            calls = k7 if who == "K7" else comp
            for i in (0, 1):
                t[who][i].append(median_ms(calls[i]))
        print(f"  K7 vs the unfused composition, encoder layers 1-4 (cuDNN "
              f"conv + ChannelNorm + ReLU, channels-first; autograd "
              f"backward with dW), {str(dtype)[6:]}, in turns: forward K7 "
              f"{t['K7'][0][0]:.4f} / {t['K7'][0][1]:.4f} ms, composition "
              f"{t['composition'][0][0]:.4f} / {t['composition'][0][1]:.4f} "
              f"ms; backward K7 {t['K7'][1][0]:.4f} / {t['K7'][1][1]:.4f} "
              f"ms, composition {t['composition'][1][0]:.4f} / "
              f"{t['composition'][1][1]:.4f} ms", flush=True)
        del layers, dys, saved, k7, comp
        torch.cuda.empty_cache()


def block_composition(args, dout, B: int, nh: int, rate: float, seed):
    """(forward, backward) of the heads' attention block as they run it
    without CPC_ATTN_BLOCK (criterion/stacked_heads.py): cuBLAS
    projections, K2, cuBLAS Wo and the residual, the backward by autograd
    with every weight's gradient; on K6's inputs.  A composition of calls,
    not one call, so it is no library time."""
    from cpc_audio_tpu_torch.ops import head_attention as ha
    leaves = [t.detach().requires_grad_(True) for t in args]
    c, wq, wk, wv, wo, krel = leaves

    def fwd():
        q, k, v = (torch.matmul(c, w) for w in (wq, wk, wv))
        y = ha.relpos_attention(q, k, v, krel, B, nh, rate, seed)
        return torch.matmul(y, wo) + c
    x = fwd()
    return fwd, lambda: torch.autograd.grad(x, leaves, dout,
                                            retain_graph=True)


def block_composition_times(dev: torch.device, B: int = 32) -> None:
    """K6 beside the unfused composition (:func:`block_composition`) at
    the default train shape (K 12, B 32, S 116, 8 x 32), dropout 0.1, in
    both dtypes and directions, in turns (K6, composition, composition,
    K6), device time a call."""
    from cpc_audio_tpu_torch.ops import attention_block as ab
    K, S, nh, dk = 12, 116, 8, 32
    D, M = nh * dk, B * S
    seed = torch.tensor([SEED], dtype=torch.int64, device=dev)
    for dtype in (torch.bfloat16, torch.float32):
        g = torch.Generator(device=dev).manual_seed(SEED + 10)

        def rand(*shape, scale=1.0):
            return (torch.randn(shape, generator=g, device=dev)
                    * scale).to(dtype)
        args = (rand(M, D),) + tuple(rand(K, D, D, scale=D ** -0.5)
                                     for _ in range(4)) \
            + (rand(K, dk, S, scale=0.5),)
        dout = rand(K, M, D, scale=0.1)
        saved = ab.attention_block_fwd(*args, B, nh, 0.1, seed)[1]
        k6 = (lambda: ab.attention_block_fwd(*args, B, nh, 0.1, seed),
              lambda: ab.attention_block_bwd(*args, dout, saved, B, nh, 0.1,
                                             seed))
        comp = block_composition(args, dout, B, nh, 0.1, seed)
        t = {"K6": [[], []], "composition": [[], []]}
        for who in ("K6", "composition", "composition", "K6"):
            calls = k6 if who == "K6" else comp
            for i in (0, 1):
                t[who][i].append(median_ms(calls[i]))
        print(f"  K6 vs the unfused composition (cuBLAS projections + K2 + "
              f"cuBLAS Wo + residual, autograd backward with dW), "
              f"{str(dtype)[6:]}, rate 0.1, in turns: forward K6 "
              f"{t['K6'][0][0]:.4f} / {t['K6'][0][1]:.4f} ms, composition "
              f"{t['composition'][0][0]:.4f} / {t['composition'][0][1]:.4f} "
              f"ms; backward K6 {t['K6'][1][0]:.4f} / {t['K6'][1][1]:.4f} "
              f"ms, composition {t['composition'][1][0]:.4f} / "
              f"{t['composition'][1][1]:.4f} ms", flush=True)
        del args, dout, saved, k6, comp
        torch.cuda.empty_cache()


def counters():
    from cpc_audio_tpu_torch.ops import (attention_block, causal_attention,
                                         conv_ln, ffn, gru, head_attention,
                                         lstm, scatter_add)
    return {"lstm_fwd": lstm.lstm_fwd, "lstm_bwd": lstm.lstm_bwd,
            "relpos_attention_fwd": head_attention.relpos_attention,
            "relpos_attention_bwd": head_attention.relpos_attention_bwd,
            "layer_tail_fwd": ffn.layer_tail,
            "layer_tail_bwd": ffn.layer_tail_bwd,
            "gru_fwd": gru.gru_fwd, "gru_bwd": gru.gru_bwd,
            "causal_attention_fwd": causal_attention.causal_attention_fwd,
            "causal_attention_bwd": causal_attention.causal_attention_bwd,
            "attention_block_fwd": attention_block.attention_block,
            "attention_block_bwd": attention_block.attention_block_bwd,
            "conv_ln_fwd": conv_ln.conv_ln_relu,
            "conv_ln_bwd": conv_ln.conv_ln_relu_bwd,
            "scatter_add_rows": scatter_add.scatter_add_rows}


# the kernels of each path: its AR's and the heads' (K2, K3); the fused-
# layer path (CPC_ATTN_BLOCK=1, CPC_PALLAS_CONV=1) runs K6 in place of K2
# and K7 in encoder layers 1-4; the exact sampler's path adds K8, the
# backward of its negatives' gather
HEADS = ("relpos_attention_fwd", "relpos_attention_bwd", "layer_tail_fwd",
         "layer_tail_bwd")
FUSED = "LSTM fused"
EXACT = "LSTM exact"
WIDE = "transformer 512"          # --hiddenEncoder 512 --hiddenGar 512
LONG = "LSTM 40960/512"      # --sizeWindow 40960 --hiddenEncoder 512 ..
W768 = "LSTM 768"            # --hiddenEncoder 768 --hiddenGar 768
F32 = "LSTM float32"         # --compute_dtype float32, the CLIs' default
F512 = "LSTM 512 float32"    # --hiddenEncoder 512 --hiddenGar 512, float32
F768 = "LSTM 768 float32"    # --hiddenEncoder 768 --hiddenGar 768, float32
W200 = "LSTM 200"            # --hiddenEncoder 200 --hiddenGar 200
W1056 = "LSTM 1056"          # --hiddenEncoder 1056 --hiddenGar 1056
G512 = "GRU 512"             # --hiddenEncoder 512 --hiddenGar 512
T32 = "transformer float32"  # the transformer AR in float32, default widths
T2048 = "transformer 2048 float32"   # --hiddenEncoder 2048 --hiddenGar 2048
T163840 = "transformer 163840 float32"   # --sizeWindow 163840
# the long-window and wide paths (phase_long_and_wide), B 4: the default
# model over 41 s windows (K2 at the heads' S 4084), the transformer AR
# over them (K5 at S 4096) and at --hiddenEncoder 4096 (K5 and the heads'
# K2 at dk 512, on their DKP-512 tensor-core bodies), each in both dtypes;
# the default model at --hiddenEncoder 4160 (the heads' K2 past dk 512, on
# its cluster body at dk 520; K1 on its grid body at H 4160), bf16
L655 = "LSTM 655360"                 # --sizeWindow 655360
L655F = "LSTM 655360 float32"
T655 = "transformer 655360"          # --arMode transformer --sizeWindow ..
T655F = "transformer 655360 float32"
T4096 = "transformer 4096"           # --hiddenEncoder 4096 --hiddenGar ..
T4096F = "transformer 4096 float32"
L4160 = "LSTM 4160"                  # --hiddenEncoder 4160 --hiddenGar ..
LONG_WIDE_PATHS = (L655, L655F, T655, T655F, T4096, T4096F, L4160)
FLOAT32_PATHS = (F32, F512, F768, T32, T2048, T163840, L655F, T655F,
                 T4096F)
# paths at B 4, the batch their widths or window leave room for on the
# card's memory beside the plain versions' checks; 4 timed steps
SMALL_PATHS = (T2048, T163840)
PATH_KERNELS = {"LSTM": ("lstm_fwd", "lstm_bwd") + HEADS,
                "GRU": ("gru_fwd", "gru_bwd") + HEADS,
                "transformer": ("causal_attention_fwd",
                                "causal_attention_bwd") + HEADS,
                FUSED: ("lstm_fwd", "lstm_bwd", "attention_block_fwd",
                        "attention_block_bwd", "layer_tail_fwd",
                        "layer_tail_bwd", "conv_ln_fwd", "conv_ln_bwd"),
                EXACT: ("lstm_fwd", "lstm_bwd") + HEADS
                + ("scatter_add_rows",),
                WIDE: ("causal_attention_fwd", "causal_attention_bwd")
                + HEADS,
                LONG: ("lstm_fwd", "lstm_bwd") + HEADS,
                W768: ("lstm_fwd", "lstm_bwd") + HEADS,
                F32: ("lstm_fwd", "lstm_bwd") + HEADS,
                F512: ("lstm_fwd", "lstm_bwd") + HEADS,
                F768: ("lstm_fwd", "lstm_bwd") + HEADS,
                W200: ("lstm_fwd", "lstm_bwd") + HEADS,
                W1056: ("lstm_fwd", "lstm_bwd") + HEADS,
                G512: ("gru_fwd", "gru_bwd") + HEADS,
                T32: ("causal_attention_fwd", "causal_attention_bwd")
                + HEADS,
                T2048: ("causal_attention_fwd", "causal_attention_bwd")
                + HEADS,
                T163840: ("causal_attention_fwd", "causal_attention_bwd")
                + HEADS,
                **{path: ("lstm_fwd", "lstm_bwd") + HEADS
                   for path in (L655, L655F, L4160)},
                **{path: ("causal_attention_fwd", "causal_attention_bwd")
                   + HEADS for path in (T655, T655F, T4096, T4096F)}}
# CPCConfig fields a path sets beside arMode
PATH_CONFIG = {EXACT: {"negativeSamplingMode": "exact"},
               WIDE: {"hiddenEncoder": 512, "hiddenGar": 512},
               LONG: {"sizeWindow": 40960, "hiddenEncoder": 512,
                      "hiddenGar": 512},
               W768: {"hiddenEncoder": 768, "hiddenGar": 768},
               F512: {"hiddenEncoder": 512, "hiddenGar": 512},
               F768: {"hiddenEncoder": 768, "hiddenGar": 768},
               W200: {"hiddenEncoder": 200, "hiddenGar": 200},
               W1056: {"hiddenEncoder": 1056, "hiddenGar": 1056},
               G512: {"hiddenEncoder": 512, "hiddenGar": 512},
               T2048: {"hiddenEncoder": 2048, "hiddenGar": 2048},
               T163840: {"sizeWindow": 163840},
               **{path: {"sizeWindow": 655360}
                  for path in (L655, L655F, T655, T655F)},
               **{path: {"hiddenEncoder": 4096, "hiddenGar": 4096}
                  for path in (T4096, T4096F)},
               L4160: {"hiddenEncoder": 4160, "hiddenGar": 4160}}
# the body the AR's backward kernel (K1, K4) must run on a path: the
# cluster body at hiddenGar 256 (and 128) and, on 16 CTAs, at 512 and 768
# in both dtypes (with part of W_hh streamed from L2 at 768, and in
# float32, on W_hh's two bf16 planes, at 512 too); the rows body at 200;
# the grid body (W_hh split over every SM) at 1056, and K4's at 512
BWD_BODY = {"LSTM": "cluster", "GRU": "cluster", FUSED: "cluster",
            EXACT: "cluster", LONG: "cluster", W768: "cluster",
            F32: "cluster", F512: "cluster", F768: "cluster", W200: "rows",
            W1056: "grid", G512: "grid", L655: "cluster", L655F: "cluster",
            L4160: "grid"}
# the body the AR's forward kernel must run: K1's 16-CTA cluster body at
# hiddenGar 256, 512 and 768 in both dtypes, its rows body at 200, its
# grid body at 1056; K4's 16-CTA cluster body at 256, its grid body at
# 512
FWD_BODY = {"LSTM": "cluster", FUSED: "cluster", EXACT: "cluster",
            LONG: "cluster", W768: "cluster", F32: "cluster",
            F512: "cluster", F768: "cluster", W200: "rows", W1056: "grid",
            "GRU": "cluster", G512: "grid", L655: "cluster",
            L655F: "cluster", L4160: "grid"}
# K2's body where a path leaves the tensor-core one: the cluster body past
# dk 512 (the heads of --hiddenEncoder 4160, dk 520, on two CTAs a tile)
K2_BODY = {L4160: "cluster"}
# launches a step, where a path fixes them: on the fused path K2 must not
# run at all; on the exact path K8 runs once, in the backward
PER_STEP = {FUSED: {"attention_block_fwd": 1, "attention_block_bwd": 1,
                    "conv_ln_fwd": 4, "conv_ln_bwd": 4,
                    "relpos_attention_fwd": 0, "relpos_attention_bwd": 0},
            EXACT: {"scatter_add_rows": 1},
            LONG: {"relpos_attention_fwd": 1, "relpos_attention_bwd": 1},
            **{path: {"relpos_attention_fwd": 1, "relpos_attention_bwd": 1,
                      "causal_attention_fwd": 1, "causal_attention_bwd": 1}
               for path in LONG_WIDE_PATHS}}


def reset_counts() -> dict:
    fns = counters()
    for fn in fns.values():
        fn.launches = 0
        for body in getattr(fn, "body_launches", {}):
            fn.body_launches[body] = 0
    return fns


def check_body(fns: dict, path: str, steps: int, want: str,
               name: str = None) -> None:
    """The AR's backward kernel (or kernel ``name``) ran body ``want``
    (BWD_BODY, FWD_BODY) ``steps`` times since reset_counts, and no other
    body."""
    name = name or ("lstm_bwd" if path.startswith("LSTM") else "gru_bwd")
    got = dict(fns[name].body_launches)
    print(f"{path}: {name} launches by body {got}", flush=True)
    if got[want] != steps or sum(got.values()) != steps:
        fail(f"the {path} ran {name}'s bodies {got}, not {want} x {steps}")


def read_counts(fns: dict, path: str, names, steps: int = 0,
                per_step: dict = None) -> dict:
    """The launches since reset_counts; each of ``names`` must have run.
    Over ``steps`` forward-and-backward or forward steps, each kernel of
    ``per_step`` (a path's PER_STEP) must have run exactly that many times
    a step where it is among ``names``, and those of 0 never."""
    launches = {name: fn.launches for name, fn in fns.items()}
    print(f"{path} launches: {launches}", flush=True)
    for name in names:
        if launches[name] <= 0:
            fail(f"the {path} did not launch {name}")
    for name, per in (per_step or {}).items():
        if (name in names or per == 0) and launches[name] != per * steps:
            fail(f"the {path} launched {name} {launches[name]} times, not "
                 f"{per} x {steps}")
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




@contextlib.contextmanager
def switches(path: str):
    """The fused-layer path's two switches, set while its model and
    criterion are built (build_model and build_criterion read them)."""
    names = ("CPC_ATTN_BLOCK", "CPC_PALLAS_CONV")
    saved = {n: os.environ.get(n) for n in names}
    for n in names:
        os.environ[n] = "1" if path == FUSED else "0"
    try:
        yield
    finally:
        for n, v in saved.items():
            if v is None:
                os.environ.pop(n)
            else:
                os.environ[n] = v


def build(path: str, dtype: str, generator: torch.Generator):
    """Model and criterion at the default CPCConfig on ``path`` (an
    --arMode, FUSED: LSTM with both fused-layer switches, or EXACT: LSTM
    with the exact sampler); the criterion is sized from ``model.config``,
    whose hiddenGar build_model sets for the mode, as the trainer does."""
    from cpc_audio_tpu_torch.config import CPCConfig
    from cpc_audio_tpu_torch.criterion import build_criterion
    from cpc_audio_tpu_torch.models import build_model
    with switches(path):
        model = build_model(CPCConfig(compute_dtype=dtype,
                                      arMode=path.split()[0],
                                      **PATH_CONFIG.get(path, {})),
                            generator)
        crit = build_criterion(model.config, generator)
    return model, crit


def check_hidden(hidden, ar_mode: str, B: int, H: int) -> None:
    """The carried state: an (h, c) pair (LSTM), one tensor (GRU), None
    (transformer), each state (1, B, H) and finite."""
    if ar_mode == "transformer":
        if hidden is not None:
            fail(f"the transformer AR returned a hidden state "
                 f"{type(hidden)}")
        return
    for h in (list(hidden) if ar_mode == "LSTM" else [hidden]):
        if tuple(h.shape) != (1, B, H) or not torch.isfinite(h.float()).all():
            fail(f"bad hidden state {tuple(h.shape)}")


def phase_eval(dev: torch.device, path: str = "LSTM",
               B: int = 32) -> dict:
    """make_val_step at full width in bf16; for the default LSTM also its
    time, the float32 card-vs-CPU check and build_feature."""
    from cpc_audio_tpu_torch.parallel.train_step import make_val_step

    ar_mode = path.split()[0]
    model, crit = build(path, "bfloat16", torch.Generator().manual_seed(SEED))
    model, crit, cfg = model.to(dev), crit.to(dev), model.config
    step = make_val_step(model, crit, dev)
    batch = torch.from_numpy(synthetic_audio(cfg.sizeWindow, B, SEED)).to(dev)
    keys = round_keys(SEED)

    fns = reset_counts()
    hidden, metrics = step(batch, round_keys=keys)
    torch.cuda.synchronize()
    launches = read_counts(fns, f"{path} eval step",
                           [n for n in PATH_KERNELS[path]
                            if n.endswith("_fwd")], 1, PER_STEP.get(path))

    K = cfg.nPredicts
    losses, acc = metrics["losses"].float().cpu(), metrics["acc"].cpu()
    print(f"{path} eval step (B={B}, bf16): losses="
          f"{losses.numpy().round(4)} acc={acc.numpy().round(4)}",
          flush=True)
    if tuple(losses.shape) != (K,) or tuple(acc.shape) != (K,):
        fail(f"metrics shapes {tuple(losses.shape)} {tuple(acc.shape)}")
    if not (torch.isfinite(losses).all() and torch.isfinite(acc).all()):
        fail("non-finite losses or accuracies")
    if not ((acc >= 0).all() and (acc <= 1).all()):
        fail("accuracy outside [0, 1]")
    check_hidden(hidden, ar_mode, B, cfg.hiddenGar)
    if path != "LSTM":
        return launches

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

    check_against_cpu(model, dev)
    check_features(model, dev)
    return launches


def check_against_cpu(model, dev: torch.device) -> None:
    """Same weights in float32: kernels on the card vs plain versions on
    the CPU, on a (2, 1, 20480) batch with the same round keys."""
    from cpc_audio_tpu_torch.criterion import build_criterion
    from cpc_audio_tpu_torch.models import build_model
    from cpc_audio_tpu_torch.parallel.train_step import make_val_step

    cfg32 = model.config.replace(compute_dtype="float32")
    gen = torch.Generator().manual_seed(SEED + 1)
    crit = build_criterion(cfg32, gen)
    results = []
    batch = synthetic_audio(cfg32.sizeWindow, 2, SEED + 1)
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


def feature_latency(model, warmup: int = 2, calls: int = 10):
    """build_feature on a 64000-sample (4 s) WAV: (features, median ms of
    ``calls`` calls after ``warmup``, host clock: the file's read and
    decode, the model's forward at B 1 over 400 frames and the copy back,
    as a user waits for it)."""
    from cpc_audio_tpu_torch.feature_loader import FeatureModule, build_feature

    wav = synthetic_audio(64000, 1, SEED + 2)[0, 0]
    times = []
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "smoke.wav")
        _write_wav(path, wav)
        module = FeatureModule(model)
        for i in range(warmup + calls):
            t0 = time.perf_counter()
            feats = build_feature(module, path)
            if i >= warmup:
                times.append(time.perf_counter() - t0)
    return feats, statistics.median(times) * 1e3


def check_features(model, dev: torch.device) -> None:
    """build_feature on the 4 s file: (1, 400, 256) finite float32
    features, K1's forward on its cluster body (B 1: one cluster, 15 of
    its 16 rows padding) once a call, and its latency."""
    from cpc_audio_tpu_torch.ops import lstm
    fns = reset_counts()
    feats, ms = feature_latency(model)
    SUMMARY["build_feature"] = (
        f"build_feature latency: {ms:.3f} ms a 4 s file (median of 10 "
        f"calls after 2, host clock, {model.config.compute_dtype}, "
        f"--hiddenGar {model.config.hiddenGar})")
    print(f"build_feature: shape {feats.shape} dtype {feats.dtype}; "
          f"{SUMMARY['build_feature']} on {gpu_line()}", flush=True)
    if feats.shape != (1, 400, 256) or feats.dtype != np.float32 \
            or not np.isfinite(feats).all():
        fail(f"build_feature gave {feats.shape} {feats.dtype}")
    check_body(fns, "build_feature", 12,
               lstm.fwd_body(model.config.hiddenGar, torch.bfloat16),
               "lstm_fwd")


def phase_train(dev: torch.device, path: str = "LSTM", B: int = 32,
                timed: int = 10) -> dict:
    """The train path of one --arMode (or the fused-layer path):
    make_train_step at the default config in bf16 (FLOAT32_PATHS: in
    float32, the CLIs' default), 2 warm-up and ``timed`` timed steps on a
    fixed batch."""
    dtype = "float32" if path in FLOAT32_PATHS else "bfloat16"
    model, crit = build(path, dtype, torch.Generator().manual_seed(SEED))
    cfg = model.config
    step, batch, key = train_setup(model, crit, dev, B)

    fns = reset_counts()
    losses, times = [], []
    n = 2 + timed
    for i in range(n):                   # 2 warm-up, then the timed ones
        t0 = time.perf_counter()
        _, metrics = step(batch, key=key)
        torch.cuda.synchronize()
        if i >= 2:
            times.append(time.perf_counter() - t0)
        losses.append(metrics["losses"])
    launches = read_counts(fns, f"{path} train step", PATH_KERNELS[path],
                           n, PER_STEP.get(path))
    if path in BWD_BODY:
        check_body(fns, path, n, BWD_BODY[path])
    if path in FWD_BODY:
        check_body(fns, path, n, FWD_BODY[path],
                   "gru_fwd" if path.startswith("GRU") else "lstm_fwd")
    if "relpos_attention_fwd" in PATH_KERNELS[path]:
        # K2 on its tensor-core body (K2_BODY: the cluster body), once a
        # step in each direction
        for name in ("relpos_attention_fwd", "relpos_attention_bwd"):
            check_body(fns, path, n, K2_BODY.get(path, "tc"), name)

    per_step = torch.stack(losses).float().cpu()          # (n, K)
    if tuple(per_step.shape) != (n, cfg.nPredicts) or \
            not torch.isfinite(per_step).all():
        fail(f"train losses {tuple(per_step.shape)} not finite")
    total = per_step.sum(dim=1)
    print(f"{path} train step losses (sum over K, steps 1-{n}): "
          f"{[round(v, 4) for v in total.tolist()]}", flush=True)
    k = max(1, timed // 3)               # the first and last timed steps
    first, last = total[2:2 + k].mean().item(), total[-k:].mean().item()
    if not last < first:
        fail(f"the {path} loss did not fall over the timed steps on a "
             f"fixed batch ({first:.4f} -> {last:.4f})")
    step_ms = statistics.median(times) * 1e3
    print(f"{path} train windows/s: {B / (step_ms / 1e3):.1f} "
          f"(make_train_step, --arMode {path}, B={B}, {dtype}, dropout 0.1, "
          f"median step {step_ms:.3f} ms of {timed}, min "
          f"{min(times) * 1e3:.3f} max {max(times) * 1e3:.3f}) on "
          f"{gpu_line()}", flush=True)
    profile_train(step, batch, key, step_ms, path)
    return launches


def train_setup(model, crit, dev: torch.device, B: int = 32):
    """(train step, fixed (B, 1, 20480) batch, epoch key) on the card."""
    from cpc_audio_tpu_torch.parallel.train_step import (create_train_state,
                                                         epoch_key,
                                                         make_train_step)
    cfg = model.config
    state = create_train_state(model, crit, dev, cfg.learningRate)
    batch = torch.from_numpy(synthetic_audio(cfg.sizeWindow, B,
                                             SEED + 3)).to(dev)
    return make_train_step(state, dev), batch, epoch_key(SEED, 0, dev)


def ab_train(dev: torch.device, other: str, B: int = 32,
             steps: int = 12) -> None:
    """Train windows/s of the default LSTM step and of path ``other`` (the
    fused-layer or the exact sampler's) in one call, in turns (default,
    other, other, default), each turn 2 warm-up and ``steps`` timed steps
    on the same fixed batch."""
    runs = {path: train_setup(*build(path, "bfloat16",
                                     torch.Generator().manual_seed(SEED)),
                              dev, B)
            for path in ("LSTM", other)}
    times = {path: [] for path in runs}
    for path in ("LSTM", other, other, "LSTM"):
        step, batch, key = runs[path]
        for i in range(2 + steps):
            t0 = time.perf_counter()
            step(batch, key=key)
            torch.cuda.synchronize()
            if i >= 2:
                times[path].append(time.perf_counter() - t0)
    ms = {path: statistics.median(t) * 1e3 for path, t in times.items()}
    what = other.split()[1]
    print(f"A/B train windows/s, LSTM, B={B}, bf16, dropout 0.1, in turns "
          f"default/{what}/{what}/default, median of {2 * steps} steps "
          f"each: default {B / ms['LSTM'] * 1e3:.1f} ({ms['LSTM']:.3f} ms), "
          f"{what} {B / ms[other] * 1e3:.1f} ({ms[other]:.3f} ms), {what} / "
          f"default step time {ms[other] / ms['LSTM']:.3f} on {gpu_line()}",
          flush=True)


def phase_stop_grad(dev: torch.device, B: int = 32, steps: int = 2) -> None:
    """Exact-sampler train steps with stopGradNegatives: no gradient
    reaches the negatives, so K8 must not launch; K1-K3 must."""
    from cpc_audio_tpu_torch.config import CPCConfig
    from cpc_audio_tpu_torch.criterion import build_criterion
    from cpc_audio_tpu_torch.models import build_model
    gen = torch.Generator().manual_seed(SEED)
    with switches("LSTM"):
        model = build_model(CPCConfig(compute_dtype="bfloat16",
                                      negativeSamplingMode="exact",
                                      stopGradNegatives=True), gen)
        crit = build_criterion(model.config, gen)
    step, batch, key = train_setup(model, crit, dev, B)
    fns = reset_counts()
    losses = [step(batch, key=key)[1]["losses"] for _ in range(steps)]
    torch.cuda.synchronize()
    read_counts(fns, "stopGradNegatives exact train step",
                PATH_KERNELS["LSTM"], steps, {"scatter_add_rows": 0})
    total = torch.stack(losses).float().sum(dim=1).cpu()
    if not torch.isfinite(total).all():
        fail(f"stopGradNegatives losses {total.tolist()}")
    print(f"stopGradNegatives exact train steps (B={B}, bf16): losses (sum "
          f"over K) {[round(v, 4) for v in total.tolist()]}, K8 launches 0",
          flush=True)


def phase_model_alone(dev: torch.device, mode: str = "GRU", H: int = 100,
                      B: int = 8, steps: int = 4, body: str = "cluster",
                      fwd_body: str = "cluster", lr: float = 1e-3) -> int:
    """--arMode ``mode`` --hiddenGar H beside --hiddenEncoder 256: at H 100
    K4 runs H padded to 128 (ops/gru.py; its 8-CTA cluster bodies) and
    sliced back, at H 200 padded to 224 (its rows bodies); at H 4096 K1
    and K4 run their grid bodies, W_hh streamed every step.  The
    transformer prediction heads need hiddenGar == hiddenEncoder, so
    build_criterion must refuse the config, naming the flag; the model
    trains alone here: ``steps`` Adam steps (rate ``lr``) of the encoder
    and the AR (bf16) on a fixed batch, the loss mean(c^2), the AR's
    kernels forward
    and backward once a step (the backward on ``body``, the forward on
    ``fwd_body``), the loss
    falling, train windows/s; then one float32 forward and backward on
    the card and on the CPU, which must agree.  Returns the bf16 steps'
    launches of the forward's body."""
    from cpc_audio_tpu_torch.config import CPCConfig
    from cpc_audio_tpu_torch.criterion import build_criterion
    from cpc_audio_tpu_torch.models import build_model
    label = f"{mode} --hiddenGar {H}"
    k = mode.lower()
    cfg = CPCConfig(arMode=mode, hiddenGar=H, compute_dtype="bfloat16")
    try:
        build_criterion(cfg)
        fail(f"build_criterion took --hiddenGar {H} beside --hiddenEncoder "
             f"{cfg.hiddenEncoder}")
    except ValueError as e:
        if "--hiddenGar" not in str(e):
            fail(f"build_criterion refused without naming the flag: {e}")
        print(f"{label}: build_criterion refuses before any step: "
              f"{str(e)[:160]}", flush=True)
    model = build_model(cfg, torch.Generator().manual_seed(SEED)).to(dev)
    batch = torch.from_numpy(synthetic_audio(cfg.sizeWindow, B,
                                             SEED + 10)).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    hidden = model.zero_state(B, dev)
    fns = reset_counts()
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        c, _, _, _ = model(batch, hidden=hidden, train=True)
        loss = (c.float() ** 2).mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.item())
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    read_counts(fns, f"{label} model step", (f"{k}_fwd", f"{k}_bwd"),
                steps, {f"{k}_fwd": 1, f"{k}_bwd": 1})
    check_body(fns, label, steps, body, f"{k}_bwd")
    check_body(fns, label, steps, fwd_body, f"{k}_fwd")
    fwd_launches = fns[f"{k}_fwd"].body_launches[fwd_body]
    step_ms = statistics.median(times[1:]) * 1e3
    print(f"{label} model train steps (B={B}, bf16, the AR's kernels at H "
          f"{H}): losses {[round(v, 6) for v in losses]}; windows/s "
          f"{B / (step_ms / 1e3):.1f} (encoder and AR alone, loss "
          f"mean(c^2), median step {step_ms:.3f} ms of the last "
          f"{steps - 1}) on {gpu_line()}", flush=True)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"{label}: the loss did not fall: {losses}")
    cfg32 = cfg.replace(compute_dtype="float32")
    x = synthetic_audio(cfg.sizeWindow, 2, SEED + 12)
    outs = []
    for device in (dev, torch.device("cpu")):
        m = build_model(cfg32)
        m.load_state_dict(model.state_dict())
        m.to(device)
        c, _, _, _ = m(torch.from_numpy(x).to(device),
                       hidden=m.zero_state(2, device))
        (c.float() ** 2).mean().backward()
        outs.append((c.detach().float().cpu(),
                     {n: p.grad.float().cpu() for n, p in
                      m.gAR.named_parameters()}))
        del m
    (c_g, g_g), (c_c, g_c) = outs
    print(f"float32 {label}, card (kernels) vs CPU (plain):", flush=True)
    compare("c", c_g, c_c, 1e-3, 1e-3, f"f32, 128 {mode} steps")
    for n in sorted(g_c):
        compare_norm(f"grad gAR.{n}", g_g[n], g_c[n], 1e-3,
                     "f32 sums in another order over 128 steps")
    return fwd_launches


def phase_eval_auto_exact(dev: torch.device, B: int = 24) -> None:
    """The default config (negativeSamplingMode auto) at B = 24: B*S =
    3072 is no power of two, so the sampler resolves to exact; one
    make_val_step with the round keys and negatives' seed derived on the
    device, as the CLI's validation pass does."""
    from cpc_audio_tpu_torch.parallel.train_step import (epoch_key,
                                                         make_val_step,
                                                         step_streams)
    model, crit = build("LSTM", "bfloat16",
                        torch.Generator().manual_seed(SEED))
    model, crit, cfg = model.to(dev), crit.to(dev), model.config
    sampler = crit.sampler(B, cfg.sizeWindow // 160)
    if cfg.negativeSamplingMode != "auto" or sampler != "exact":
        fail(f"auto at B={B} resolved to {sampler!r}, not 'exact'")
    batch = torch.from_numpy(synthetic_audio(cfg.sizeWindow, B, SEED)).to(dev)
    _, keys, neg_seed = step_streams(epoch_key(SEED, 1, dev),
                                     torch.zeros((), dtype=torch.int64,
                                                 device=dev))
    fns = reset_counts()
    _, metrics = make_val_step(model, crit, dev)(batch, round_keys=keys,
                                                 neg_seed=neg_seed)
    torch.cuda.synchronize()
    read_counts(fns, f"eval step at B={B}",
                [n for n in PATH_KERNELS[EXACT] if n.endswith("_fwd")])
    losses, acc = metrics["losses"].float().cpu(), metrics["acc"].cpu()
    if tuple(losses.shape) != (cfg.nPredicts,) or not (
            torch.isfinite(losses).all() and (acc >= 0).all()
            and (acc <= 1).all()):
        fail(f"eval at B={B}: losses {losses.tolist()} acc {acc.tolist()}")
    print(f"eval step at B={B} (auto -> {sampler}, bf16): losses="
          f"{losses.numpy().round(4)} acc={acc.numpy().round(4)}", flush=True)


def profile_train(step, batch, key, step_ms: float, path: str,
                  n: int = 3) -> None:
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
    # K1's forward at H 768 in float32 runs its own kernel
    # (csrc/lstm_fwd.cu lstm_fwd_stream_kernel), the other cluster
    # forwards the template's; fwd_body says "cluster" for both
    stream = any("lstm_fwd_stream_kernel" in e.key for e in rows)
    if stream != (path == F768):
        ran = "ran" if stream else "did not run"
        fail(f"{path}: lstm_fwd_stream_kernel {ran} in the train step "
             f"(only {F768} runs it)")
    busy = sum(e.self_device_time_total for e in rows) / 1e3 / n
    print(f"{path} train step profile ({n} steps): {len(rows)} distinct "
          f"kernels, {sum(e.count for e in rows) // n} launches and "
          f"{busy:.3f} ms of device time per step; the unprofiled step "
          f"takes {step_ms:.3f} ms, so the device is busy "
          f"{100 * busy / step_ms:.1f} % of it. Device ms per step by "
          f"kernel:", flush=True)
    port = PROFILE_GROUPS[0][1]
    shown = rows[:25] + [e for e in rows[25:]
                         if any(w in e.key.lower() for w in port)]
    for e in shown:
        print(f"  {e.self_device_time_total / 1e3 / n:9.3f} ms  "
              f"{e.count // n:5d}x  {e.key[:100]}", flush=True)
    rest = [e for e in rows if e not in shown]
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
    # K3 by direction: both launch LN1 and (in float32) the split once (and
    # past D 1024 the wide body's G2), the forward's G1 (G1_hidden<E,
    # false>) and G2 (G2_out; the wide body's LN2 pass) are its own
    tail = {"fwd": 0.0, "bwd": 0.0}
    for e in rows:
        name = e.key.lower()
        if "tail_" not in name:
            continue
        t = e.self_device_time_total / 1e3 / n
        if any(w in name for w in ("tail_ln1_", "tail_split_kernel",
                                   "g2_wide")):
            tail["fwd"] += t / 2
            tail["bwd"] += t / 2
        elif "g2_out" in name or "tail_ln2_out" in name or (
                "g1_hidden" in name and "false>" in name):
            tail["fwd"] += t
        else:
            tail["bwd"] += t
    print(f"  K3 forward {tail['fwd']:.3f} ms, backward (but its sums over "
          f"tiles) {tail['bwd']:.3f} ms (LN1, the split and a wide body's "
          f"G2 halved between the two)", flush=True)
    # K6 by launch (the fused-layer path): its GEMMs and splits
    # (csrc/attention_block_tc.cuh)
    k6 = {}
    for e in rows:
        name = e.key.lower()
        if "k6::" in name:
            part = next((u for u in ("proj", "out", "dy", "dw", "dcp")
                         if f"k6::{u}<" in name), "split")
            k6[part] = k6.get(part, 0.0) + e.self_device_time_total / 1e3 / n
    if k6:
        print("  K6's GEMMs by launch: " + ", ".join(
            f"{part} {t:.3f} ms" for part, t in k6.items()), flush=True)
    # K2's tensor-core body by kernel: the forward, the backward's three
    # passes and its sum of the windows, and the operands' copies (krel's
    # padded planes, and the float32 split) that both directions make; on
    # the fused-layer path these are K6's, which runs K2's body through
    # K2's C entry points
    k2 = {}
    for e in rows:
        name = e.key.lower()
        for part in ("relpos_tc_fwd", "relpos_tc_bwd_rows",
                     "relpos_tc_bwd_cols", "relpos_tc_bwd_diag",
                     "dkrel_windows_reduce", "krel_planes", "head_planes"):
            if part in name:
                k2[part] = k2.get(part, 0.0) + \
                    e.self_device_time_total / 1e3 / n
    if k2:
        who = "K6's attention (K2's tensor-core body)" if path == FUSED \
            else "K2"
        print(f"  {who} by kernel: " + ", ".join(
            f"{part} {t:.3f} ms" for part, t in k2.items()), flush=True)
    if other:
        print("  largest of 'other': " + "; ".join(
            f"{e.key[:60]} {e.self_device_time_total / 1e3 / n:.3f} ms"
            for e in other[:6]), flush=True)


# kernel-name fragments (lower case) of the profile's groups, first match
PROFILE_GROUPS = (
    ("port kernels", ("lstm_fwd", "lstm_bwd", "gru_fwd_kernel",
                      "gru_bwd", "fwd_cluster_kernel", "cpc::grid::",
                      "relpos_attention", "relpos_tc",
                      "dkrel_windows", "krel_planes", "head_planes",
                      "causal_attention", "tail_", "dkrel_reduce",
                      "k6::", "conv_ln", "sum_parts",
                      "scatter_add_kernel", "split_planes",
                      "split_operands")),
    ("Adam (foreach kernels)", ("adam", "multi_tensor_apply")),
    ("cuDNN conv", ("cudnn", "conv", "nchwtonhwc", "nhwctonchw", "wgrad",
                    "dgrad")),
    ("GEMM", ("gemm", "xmma", "cutlass", "sm90_", "nvjet")),
    ("copies and casts", ("copy", "memcpy", "memset")),
    ("reductions", ("reduce_kernel",)),
    ("elementwise", ("elementwise", "index", "gather", "scatter")),
)


def check_train_against_cpu(dev: torch.device, path: str = "LSTM") -> None:
    """One float32 train step on a (2, 1, sizeWindow) batch, kernels on
    the card vs plain versions on the CPU: same weights, round keys and
    dropout seed (the dropout bits do not depend on the device)."""
    from cpc_audio_tpu_torch.ops import lstm
    from cpc_audio_tpu_torch.parallel.train_step import (create_train_state,
                                                         epoch_key,
                                                         make_train_step)

    model, crit = build(path, "float32",
                        torch.Generator().manual_seed(SEED + 4))
    batch = synthetic_audio(model.config.sizeWindow, 2, SEED + 4)
    results, tails, relu = [], [], {}
    for device in (dev, torch.device("cpu")):
        state = create_train_state(copy.deepcopy(model),
                                   copy.deepcopy(crit), device)
        fns = reset_counts()
        with record_tail_inputs() as tail, \
                encoder_relu_kinks(state.model, relu):
            _, met = make_train_step(state, device)(
                batch, key=epoch_key(SEED, 0, device))
        tails.append(tail)
        if device == dev and path in BWD_BODY and path.startswith("LSTM"):
            # float32: the bodies of K1 at the path's hiddenGar
            H = model.config.hiddenGar
            for name, want in (("lstm_fwd", lstm.fwd_body(H, torch.float32)),
                               ("lstm_bwd", lstm.bwd_body(H, torch.float32))):
                check_body(fns, f"float32 {path}", 1, want, name)
        results.append((met["losses"].float().cpu(), step_grads(state)))
    compare_train_steps(path, results, relu, tails)


def step_grads(state) -> dict:
    """The gradient of every leaf a train step left on ``state``, float32
    on the CPU."""
    return {f"{prefix}.{n}": p.grad.detach().float().cpu()
            for prefix, mod in (("model", state.model),
                                ("criterion", state.criterion))
            for n, p in mod.named_parameters()}


def compare_train_steps(path: str, results, relu: dict, tails) -> None:
    """A float32 train step's losses and gradients, the card's against the
    CPU's (``results``: [(losses, grads)] in that order), every leaf at
    1e-3 of its norm, after the encoder's ReLU units within float32
    rounding of the kink were taken on the card's side on the CPU."""
    (l_g, g_g), (l_c, g_c) = results
    print(f"float32 {path} train step, card (kernels) vs CPU (plain "
          f"versions), dropout on:", flush=True)
    forced = relu["forced"]
    print(f"  {path} encoder ReLU units the card and the CPU put on opposite "
          f"sides of 0, each within {KINK_ATOL:g} of it, taken on the card's "
          f"side on the CPU: {sum(forced.values())} "
          f"({forced}); opposite and farther apart: {relu['apart']}",
          flush=True)
    if relu["apart"] or sum(forced.values()) > MAX_ENCODER_KINKS:
        fail(f"the {path} encoder's ReLU inputs disagree in sign between the "
             f"card and the CPU beyond float32 rounding of the kink")
    compare(f"{path} train losses", l_g, l_c, 1e-3, 1e-3,
            f"f32 through the {path} AR, heads and InfoNCE")
    for name in sorted(g_c):
        compare_norm(f"{path} grad {name}", g_g[name], g_c[name], 1e-3,
                     "f32 sums in another order through the whole step, "
                     "cuDNN convs, ReLU-kink flips")
    worst = {}
    for name in g_c:
        group = next(g for g, prefix in LEAF_GROUPS if name.startswith(prefix))
        err = ((g_g[name] - g_c[name]).norm() / g_c[name].norm()).item()
        worst[group] = max(worst.get(group, (0.0, "")), (err, name))
    print(f"  {path} worst gradient leaf per group (rel_norm_err): " +
          "; ".join(f"{g} {e:.3e} ({n})" for g, (e, n) in worst.items()),
          flush=True)
    if all(tails):                  # the heads' K3 ran on this path
        kink_report(path, tails, g_g, g_c)


# An encoder ReLU unit (the output of a ChannelNorm, O(1)) whose card and
# CPU values lie on opposite sides of 0, both within KINK_ATOL of it, is
# within float32 rounding of the kink (the two encoders' outputs agree to
# a few 1e-6): whichever branch it takes moves its whole upstream
# gradient into every encoder leaf below it, up to 6e-3 of their norms at
# --hiddenEncoder 1056 (port_perf/train_step_errors.py).  The CPU takes
# the card's branch there, at most MAX_ENCODER_KINKS such units a step.
KINK_ATOL = 1e-5
MAX_ENCODER_KINKS = 8


@contextlib.contextmanager
def encoder_relu_kinks(model, relu: dict):
    """While a train step runs: on the first device (``relu`` empty),
    records each ChannelNorm output of the model's encoder (the encoder's
    ReLU inputs, on the CPU); on the second, gives each unit that the two
    put on opposite sides of 0, both within KINK_ATOL of it, the first's
    value, and counts them in ``relu["forced"]`` by layer, and the
    opposite-signed units farther apart in ``relu["apart"]``."""
    first = "card" not in relu
    if first:
        relu["card"] = {}
    else:
        relu["forced"], relu["apart"] = {}, 0
    hooks = []

    def hook(name, out):
        if first:
            relu["card"][name] = out.detach().float().cpu()
            return None
        card = relu["card"][name].to(out.dtype)
        opposite = (out > 0) != (card > 0)
        near = (out.abs() < KINK_ATOL) & (card.abs() < KINK_ATOL)
        relu["forced"][name] = int((opposite & near).sum())
        relu["apart"] += int((opposite & ~near).sum())
        # the card's value there, the gradient still through out
        return out + torch.where(opposite & near, card - out, 0.0).detach()
    for name, mod in model.gEncoder.named_children():
        if name.startswith("norm"):
            hooks.append(mod.register_forward_hook(
                lambda m, args, out, name=name: hook(name, out)))
    try:
        yield
    finally:
        for h in hooks:
            h.remove()


# gradient leaves by where they sit in the step, first matching prefix
LEAF_GROUPS = (("encoder", "model.gEncoder."), ("AR", "model.gAR."),
               ("heads FFN lin1", "criterion.wPrediction.heads.layer0."
                "ffnetwork.lin1."),
               ("heads, rest", "criterion.wPrediction."),
               ("criterion, rest", "criterion."))


@contextlib.contextmanager
def record_tail_inputs():
    """Records, on the CPU, the arguments of the heads' K3 call
    (stacked_heads.layer_tail) while the block runs; the call itself is
    unchanged and still launches the kernel."""
    import inspect
    from cpc_audio_tpu_torch.criterion import stacked_heads
    original = stacked_heads.layer_tail
    record = {}

    def spy(*args, **kwargs):
        bound = inspect.signature(original).bind(*args, **kwargs)
        bound.apply_defaults()
        # copies: on the CPU, w1 and b1 are the parameters Adam updates
        record.update({k: v.detach().to("cpu", copy=True)
                       if isinstance(v, torch.Tensor) else v
                       for k, v in bound.arguments.items()})
        return original(*args, **kwargs)

    stacked_heads.layer_tail = spy
    try:
        yield record
    finally:
        stacked_heads.layer_tail = original


def _relu_inputs(a: dict):
    """float64 (K, M, F) pre-activations LN1(x).W1 + b1 of the heads' FFN
    from one device's recorded K3 input, and the dropout keep mask."""
    from cpc_audio_tpu_torch.ops import dropout
    x = a["x"].double()
    xc = x - x.mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + a["eps"])
    y = y * a["ln1w"].double()[:, None] + a["ln1b"].double()[:, None]
    pre = y @ a["w1"].double() + a["b1"].double()[:, None]
    mask = dropout.ffn_mask(a["seed"], a["rate"], *pre.shape, "cpu")
    return pre, (torch.ones_like(pre, dtype=torch.bool) if mask is None
                 else mask > 0)


def kink_report(ar_mode: str, tails, g_g: dict, g_c: dict) -> None:
    """Where the card's and the CPU's heads' FFN lin1 gradients part: the
    share of ||d(lin1.bias)||^2 in its largest (head, unit) entries, and
    the heads' ReLU units (kept by dropout) whose pre-activation, in
    float64 from each device's own K3 input, has opposite signs on the
    card and the CPU, or lies within 1e-6 of 0 on the CPU.  Such a unit
    takes the other ReLU branch in one version, and its whole row of dh
    then differs."""
    (pre_g, keep), (pre_c, _) = (_relu_inputs(t) for t in tails)
    flips = keep & ((pre_g > 0) != (pre_c > 0))
    near = keep & (pre_c.abs() < 1e-6)
    name = "criterion.wPrediction.heads.layer0.ffnetwork.lin1.bias"
    sq = (g_g[name] - g_c[name]).double().pow(2)          # (K, F)
    total = max(sq.sum().item(), 1e-300)
    top = torch.topk(sq.flatten(), 3).indices.tolist()
    F = sq.shape[1]
    units = []
    for i in top:
        k, f = divmod(i, F)
        rows = keep[k, :, f]
        low = pre_c[k, :, f].abs().masked_fill(~rows, float("inf"))
        m = int(low.argmin())
        units.append(f"(head {k}, unit {f}) {sq[k, f].item() / total:.1%}, "
                     f"flips {int(flips[k, :, f].sum())}, nearest row {m}: "
                     f"card {pre_g[k, m, f].item():.3e} CPU "
                     f"{pre_c[k, m, f].item():.3e}")
    print(f"  {ar_mode} heads' FFN ReLU, card vs CPU: {int(flips.sum())} of "
          f"{int(keep.sum())} kept units change sign, {int(near.sum())} lie "
          f"within 1e-6 of 0; largest entries of d(lin1.bias), share of "
          f"its squared norm: " + "; ".join(units), flush=True)


def _write_wav(path: str, samples: np.ndarray, rate: int = 16000) -> None:
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((np.clip(samples, -1, 1) * 32767).astype("<i2")
                      .tobytes())


def _run_cli(train, argv, what: str, names):
    fns = reset_counts()
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        rc = train.main(argv)
    torch.cuda.synchronize()
    lines = log.getvalue().splitlines()
    print(f"train CLI {what}: rc={rc} in {time.perf_counter() - t0:.1f} s; "
          f"{[ln for ln in lines if 'Resuming' in ln or 'throughput' in ln]}",
          flush=True)
    read_counts(fns, f"train CLI ({what})", names)
    if rc != 0:
        fail(f"train CLI {what} exited {rc}: {lines[-20:]}")
    return lines


def cli_first_step_on_cpu(dev: torch.device, results: list, relu: dict,
                          tails: list):
    """While the train CLI runs: its first train step (the step
    ``train.main`` builds, under the policy it sets) runs as it is on the
    card and, from a copy of the state, on the CPU (step_on_cpu_too)."""
    from cpc_audio_tpu_torch import train
    return step_on_cpu_too(train, "make_train_step",
                           lambda o: o[1]["losses"], results, relu, tails)


def phase_cli(tmp: str, dev: torch.device) -> None:
    """cpc_audio_tpu_torch.train.main on a synthetic 2-speaker WAV tree at
    the default architecture in bf16: one epoch, then a resume to two;
    then one epoch each with --arMode GRU, with --arMode transformer and
    with --batchSizeGPU 6 (the exact sampler); then one epoch at the
    CLI's default --compute_dtype float32, whose first step is held
    against the same step on the CPU."""
    from cpc_audio_tpu_torch import train

    db = os.path.join(tmp, "db")
    rng = np.random.default_rng(SEED + 5)
    for i in range(16):
        spk = os.path.join(db, f"spk{i % 2}")
        os.makedirs(spk, exist_ok=True)
        n = int(16000 * rng.uniform(3.0, 4.0))
        t = np.arange(n) / 16000.0
        x = 0.3 * np.sin(2 * np.pi * (150 + 100 * (i % 2)) * t) \
            + 0.05 * rng.standard_normal(n)
        _write_wav(os.path.join(spk, f"f{i:03d}.wav"), x)
    # batch 6: B*S = 768, so negativeSamplingMode auto resolves to exact
    wide = ["--hiddenEncoder", "512", "--hiddenGar", "512"]
    for ar_mode, epochs, batch, extra in (
            ("LSTM", ("1", "2"), "8", []), ("GRU", ("1",), "8", []),
            ("transformer", ("1",), "8", []), ("LSTM", ("1",), "6", []),
            ("transformer", ("1",), "8", wide)):
        out = os.path.join(tmp, f"ckpt_{ar_mode}_{batch}_{len(extra)}")
        argv = ["--pathDB", db, "--file_extension", ".wav",
                "--pathCheckpoint", out, "--compute_dtype", "bfloat16",
                "--batchSizeGPU", batch, "--nEpoch", "1",
                "--n_process_loader", "2", "--ignore_cache",
                "--random_seed", str(SEED), "--arMode", ar_mode] + extra
        names = PATH_KERNELS[EXACT if batch == "6" else ar_mode]
        for n_epoch in epochs:
            argv[argv.index("--nEpoch") + 1] = n_epoch
            lines = _run_cli(train, argv,
                             f"--arMode {ar_mode} --batchSizeGPU {batch} "
                             f"{' '.join(extra)} --nEpoch {n_epoch}", names)
            files = sorted(os.listdir(out))
            want = f"checkpoint_{int(n_epoch) - 1}.pt"
            for f in (want, "checkpoint_logs.json", "checkpoint_args.json"):
                if f not in files:
                    fail(f"train CLI did not write {f} (found {files})")
        if len(epochs) > 1 and not any("Resuming from checkpoint" in ln
                                       for ln in lines):
            fail("the --nEpoch 2 rerun did not resume")
        with open(os.path.join(out, "checkpoint_logs.json")) as f:
            logs = json.load(f)
        if logs["epoch"] != list(range(len(epochs))) or not np.isfinite(
                np.asarray(logs["locLoss_train"], np.float64)).all():
            fail(f"train CLI logs: epochs {logs['epoch']}")
        print(f"train CLI --arMode {ar_mode} --batchSizeGPU {batch} "
              f"{' '.join(extra)}: epochs {logs['epoch']}, train "
              f"loss per epoch "
              f"{[round(float(np.mean(v)), 4) for v in logs['locLoss_train']]}"
              f"; files {files}", flush=True)
    # the CLI's own float32 step: train.main sets the precision policy and
    # builds the step; its first step is repeated on the CPU
    results, relu, tails = [], {}, []
    argv = ["--pathDB", db, "--file_extension", ".wav", "--pathCheckpoint",
            os.path.join(tmp, "ckpt_f32"), "--batchSizeGPU", "8",
            "--nEpoch", "1", "--n_process_loader", "2", "--ignore_cache",
            "--random_seed", str(SEED)]
    torch.backends.cudnn.allow_tf32 = True      # PyTorch's default
    with cli_first_step_on_cpu(dev, results, relu, tails):
        _run_cli(train, argv, "--compute_dtype float32 (the default)",
                 PATH_KERNELS["LSTM"])
    if (torch.backends.cudnn.allow_tf32
            or torch.backends.cuda.matmul.allow_tf32):
        fail("the train CLI left TF32 on under --compute_dtype float32")
    if len(results) != 2:
        fail(f"the train CLI's first step ran {len(results)} times, not on "
             f"the card and on the CPU")
    compare_train_steps("train CLI LSTM", results, relu, tails)
    # a config the port refuses stops before any step, naming its flag
    argv = ["--pathDB", db, "--file_extension", ".wav", "--pathCheckpoint",
            os.path.join(tmp, "ckpt_refused"), "--arMode", "GRU",
            "--hiddenGar", "100", "--ignore_cache"]
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            train.main(argv)
        fail("train CLI took --arMode GRU --hiddenGar 100")
    except ValueError as e:
        if "--hiddenGar" not in str(e):
            fail(f"train CLI refused without naming the flag: {e}")
        print(f"train CLI --arMode GRU --hiddenGar 100: refused before any "
              f"step: {str(e)[:120]}", flush=True)


# the ragged files of phase_features: 12 WAVs of 3-9 s, n_lanes lanes of
# max_size_seq (64000-sample) chunks, the default --hiddenGar: K1's forward
# at B 8 / T 400 / H 256 from the carried (non-zero) state
FEATURE_FILES, FEATURE_LANES, FEATURE_SPEAKERS = 12, 8, 3
FEATURES_SHAPE = "B 8 / T 400 / H 256"
# the CLI's tolerances for what the export and the lanes change: nothing in
# float32 (same weights, same kernels, the same rows); in bf16 the batched
# forward runs B 8 rows where build_feature runs 1 (other cuBLAS tiles in
# the input projection, other rounding to bf16), carried over 400-1200
# recurrent steps: a few bf16 ulps of |c| < 1
FEATURE_ATOL = {"float32": 1e-4, "bfloat16": 3e-2}


def default_argv(db: str, out: str, dtype: str, *extra) -> list:
    """The train CLI at the default architecture (--hiddenEncoder 256
    --hiddenGar 256, LSTM, 12 heads), one epoch, batch 8."""
    return ["--pathDB", db, "--file_extension", ".wav", "--pathCheckpoint",
            out, "--compute_dtype", dtype, "--batchSizeGPU", "8",
            "--nEpoch", "1", "--n_process_loader", "2", "--ignore_cache",
            "--random_seed", str(SEED)] + list(extra)


@contextlib.contextmanager
def first_step_record(record: dict):
    """While the train CLI runs: its first train step's arguments and
    losses go to ``record``; the step itself is unchanged."""
    from cpc_audio_tpu_torch import train
    original = train.make_train_step

    def spy(state, device):
        step = original(state, device)

        def first(*args, **kw):
            out = step(*args, **kw)
            if not record:
                record.update(args=args, kw=kw,
                              losses=out[1]["losses"].float().cpu())
            return out
        return first

    train.make_train_step = spy
    try:
        yield
    finally:
        train.make_train_step = original


def model_features(model, batch: torch.Tensor) -> torch.Tensor:
    with torch.inference_mode():
        c, z, _, _ = model(batch)
    return torch.cat([c.float(), z.float()], dim=-1)


def phase_export(tmp: str, db: str, dev: torch.device) -> dict:
    """Per dtype (bf16, then the CLI's default float32): one CLI epoch with
    --export_torch, then `convert export` of its checkpoint_0.pt; load_model
    of the port checkpoint, of checkpoint_0.torch.pt and of the converted
    file on the card give the trained model's c and z (bit for bit in
    float32, within FEATURE_ATOL in bf16); then a new CLI run with --load of
    the exported file, whose first-step losses must equal those of the
    trained model (and the new run's seeded criterion) on the same batch.
    Returns {dtype: the run's directory}."""
    from cpc_audio_tpu_torch import convert, train
    from cpc_audio_tpu_torch.criterion import build_criterion
    from cpc_audio_tpu_torch.feature_loader import load_model
    from cpc_audio_tpu_torch.models import build_model
    from cpc_audio_tpu_torch.parallel.train_step import (create_train_state,
                                                         make_train_step)
    runs = {}
    batch = torch.from_numpy(synthetic_audio(20480, 4, SEED + 11)).to(dev)
    for dtype in ("bfloat16", "float32"):
        out = os.path.join(tmp, f"export_{dtype}")
        _run_cli(train, default_argv(db, out, dtype, "--export_torch"),
                 f"--compute_dtype {dtype} --export_torch",
                 PATH_KERNELS["LSTM"])
        files = sorted(os.listdir(out))
        if "checkpoint_0.torch.pt" not in files:
            fail(f"--export_torch wrote no checkpoint_0.torch.pt ({files})")
        converted = os.path.join(out, "converted.pt")
        with contextlib.redirect_stdout(io.StringIO()):
            convert.main(["export", os.path.join(out, "checkpoint_0.pt"),
                          converted])
        with open(os.path.join(out, "checkpoint_args.json")) as f:
            args = json.load(f)
        feats = {}
        for name in ("checkpoint_0.pt", "checkpoint_0.torch.pt",
                     "converted.pt"):
            model, hg, he = load_model([os.path.join(out, name)])
            if next(model.parameters()).device != dev or (hg, he) != \
                    (args["hiddenGar"], args["hiddenEncoder"]):
                fail(f"load_model({name}) gave {hg}, {he} on "
                     f"{next(model.parameters()).device}")
            feats[name] = model_features(model, batch)
        want = feats["checkpoint_0.pt"]
        for name in ("checkpoint_0.torch.pt", "converted.pt"):
            same = torch.equal(feats[name], want)
            err = (feats[name] - want).abs().max().item()
            print(f"export {dtype}: load_model({name}) against the "
                  f"checkpoint's own model, c and z on a (4, 1, 20480) "
                  f"batch: bit-identical {same}, max |err| {err:.3e}",
                  flush=True)
            if dtype == "float32" and not same or \
                    err > FEATURE_ATOL[dtype]:
                fail(f"the {dtype} export {name} does not give the trained "
                     f"model's features")
        # --load of the export into a new run: its first step against the
        # trained model's on the same batch, with the run's own criterion
        record = {}
        with first_step_record(record):
            _run_cli(train, default_argv(
                db, os.path.join(tmp, f"load_{dtype}"), dtype, "--load",
                os.path.join(out, "checkpoint_0.torch.pt")),
                f"--compute_dtype {dtype} --load checkpoint_0.torch.pt",
                PATH_KERNELS["LSTM"])
        model, _, _ = load_model([os.path.join(out, "checkpoint_0.pt")])
        gen = torch.Generator().manual_seed(SEED)
        cfg = build_model(model.config, gen).config  # the CLI's draws
        state = create_train_state(model.train(), build_criterion(cfg, gen),
                                   dev, cfg.learningRate)
        _, metrics = make_train_step(state, dev)(*record["args"],
                                                 **record["kw"])
        got = metrics["losses"].float().cpu()
        err = (got - record["losses"]).abs().max().item()
        print(f"--load {dtype}: the new run's first-step losses "
              f"{record['losses'].numpy().round(5)}, the trained model's "
              f"on its batch {got.numpy().round(5)}, max |err| {err:.3e}",
              flush=True)
        if err > (1e-5 if dtype == "float32" else 1e-2):
            fail(f"--load of the {dtype} export: first-step losses differ")
        runs[dtype] = out
        del model, state
        torch.cuda.empty_cache()
    return runs


def feature_files(tmp: str) -> list:
    """FEATURE_FILES ragged WAVs of 3-9 s (tones plus noise), the first
    exactly 9 s, under FEATURE_SPEAKERS speaker directories of
    ``tmp/features`` (a speaker's tone in its own band)."""
    rng = np.random.default_rng(SEED + 13)
    paths = []
    for i in range(FEATURE_FILES):
        spk = i % FEATURE_SPEAKERS
        n = 144000 if i == 0 else int(16000 * rng.uniform(3.0, 9.0))
        t = np.arange(n) / 16000.0
        f0 = 100 + 100 * spk + rng.uniform(0, 60)
        x = 0.3 * np.sin(2 * np.pi * f0 * t) \
            + 0.05 * rng.standard_normal(n)
        os.makedirs(os.path.join(tmp, "features", f"spk{spk}"),
                    exist_ok=True)
        paths.append(os.path.join(tmp, "features", f"spk{spk}",
                                  f"f{i:02d}.wav"))
        _write_wav(paths[-1], x)
    return paths


def seq_norm_tolerance(raw: np.ndarray, normed: np.ndarray, atol: float,
                       frames: int = 400) -> np.ndarray:
    """The tolerance of seq_norm'ed features whose inputs ``raw`` agree
    within ``atol``: seq_norm divides each channel of a chunk by its std
    over the chunk's frames, so an entry y may move by (2 + |y|) atol / std
    (a 1-frame chunk gives zeros: atol)."""
    parts = []
    for t in range(0, raw.shape[1], frames):
        r = raw[:, t:t + frames]
        std = r.std(axis=1, ddof=1, keepdims=True) if r.shape[1] > 1 \
            else np.ones((1, 1, r.shape[2]))
        parts.append(atol * (2 + np.abs(normed[:, t:t + frames]))
                     / np.maximum(std, 1e-3))
    return np.concatenate(parts, axis=1)


def lane_batches(n_chunks, n_lanes: int) -> int:
    """The batches build_features_batched dispatches for files of
    ``n_chunks`` chunks: each lane takes the next file as it frees."""
    pending, lanes, batches = list(n_chunks), [0] * n_lanes, 0
    while pending or any(lanes):
        for i in range(n_lanes):
            if not lanes[i] and pending:
                lanes[i] = pending.pop(0)
        lanes = [max(0, n - 1) for n in lanes]
        batches += 1
    return batches


def phase_features(tmp: str, runs: dict, dev: torch.device) -> int:
    """build_features_batched over FEATURE_FILES ragged files in
    FEATURE_LANES lanes of 64000-sample chunks, each file's features held
    against per-file build_feature on the card: with keep_hidden, without
    it, with get_encoded and with seq_norm (its tolerance scaled by each
    chunk's per-channel std, which it divides by), for the bf16 and the
    float32 export; K1's forward runs its cluster body once a batch of
    chunks at B 8; seconds of audio a second for both paths.  Returns the
    bf16 batched run's K1 launches."""
    from cpc_audio_tpu_torch.feature_loader import (FeatureModule,
                                                    build_feature,
                                                    build_features_batched,
                                                    load_model)
    from cpc_audio_tpu_torch._common import compute_dtype
    from cpc_audio_tpu_torch.ops import lstm
    paths = feature_files(tmp)
    samples = [(os.path.getsize(p) - 44) // 2 for p in paths]  # 16-bit PCM
    chunks = [-(-n // 64000) for n in samples]
    seconds = sum(samples) / 16000
    n_batches = lane_batches(chunks, FEATURE_LANES)
    launches = 0
    for dtype, out in runs.items():
        model, _, _ = load_model([os.path.join(out, "checkpoint_0.pt")])
        raw = None
        for keep, enc, norm in ((True, False, False), (False, False, False),
                                (True, True, False), (True, False, True)):
            fm = FeatureModule(model, get_encoded=enc, keep_hidden=keep)
            fns = reset_counts()
            got = dict(build_features_batched(fm, paths, FEATURE_LANES,
                                              seq_norm=norm))
            what = (f"{dtype} keep_hidden={keep} get_encoded={enc} "
                    f"seq_norm={norm}")
            if keep and not enc and not norm:
                check_body(fns, f"build_features_batched {dtype}", n_batches,
                           lstm.fwd_body(256, compute_dtype(dtype)),
                           "lstm_fwd")
                if dtype == "bfloat16":
                    launches = fns["lstm_fwd"].launches
            want = [build_feature(fm, p, seq_norm=norm) for p in paths]
            if keep and not enc and not norm:
                raw = want
            worst = 0.0
            for i, w in enumerate(want):
                g = got.get(i)
                if g is None or g.shape != w.shape or \
                        not np.isfinite(g).all():
                    fail(f"build_features_batched {what}: file {i} gave "
                         f"{None if g is None else g.shape}, not {w.shape}")
                tol = seq_norm_tolerance(raw[i], w, FEATURE_ATOL[dtype]) \
                    if norm else FEATURE_ATOL[dtype]
                excess = np.abs(g - w) / tol
                worst = max(worst, float(excess.max()))
            print(f"build_features_batched {what}: {FEATURE_FILES} files "
                  f"({seconds:.1f} s of audio, {sum(chunks)} chunks, "
                  f"{n_batches} batches of {FEATURE_LANES} lanes) against "
                  f"build_feature: worst |err| / tolerance {worst:.3f}",
                  flush=True)
            if worst > 1.0:
                fail(f"build_features_batched {what} disagrees with "
                     f"build_feature")
        feature_rates(FeatureModule(model, keep_hidden=True), paths,
                      seconds, dtype)
        del model
        torch.cuda.empty_cache()
    return launches


def feature_rates(fm, paths: list, seconds: float, dtype: str) -> None:
    """Seconds of audio a second (host clock, decode and read-back
    included) of build_features_batched and of per-file build_feature over
    ``paths``, warm, in turns (batched, per file, per file, batched); the
    decode alone; and the device's busy share during one batched pass
    (torch.profiler: the kernels' device time over the pass's wall
    time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cpc_audio_tpu_torch.data.audio_io import decode_file
    from cpc_audio_tpu_torch.feature_loader import (build_feature,
                                                    build_features_batched)
    runs = {"batched": lambda: list(build_features_batched(
                fm, paths, FEATURE_LANES)),
            "per file": lambda: [build_feature(fm, p) for p in paths],
            "decode": lambda: [decode_file(p) for p in paths]}
    rate = {k: [] for k in runs}
    for who in ("batched", "per file", "per file", "batched", "decode"):
        t0 = time.perf_counter()
        runs[who]()
        torch.cuda.synchronize()
        rate[who].append(seconds / (time.perf_counter() - t0))
    busy = {}
    for who in ("batched", "per file"):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            runs[who]()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        device = sum(e.self_device_time_total for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA) / 1e6
        busy[who] = (device, device / wall)
    line = (f"feature extraction, {dtype}, --hiddenGar 256, {FEATURE_FILES} "
            f"files of 3-9 s ({seconds:.1f} s of audio): "
            f"{statistics.mean(rate['batched']):.1f} s of audio a second "
            f"batched ({FEATURE_LANES} lanes; "
            f"{' / '.join(f'{r:.1f}' for r in rate['batched'])}), "
            f"{statistics.mean(rate['per file']):.1f} per file "
            f"(build_feature; "
            f"{' / '.join(f'{r:.1f}' for r in rate['per file'])}), in turns, "
            f"host clock; decode alone {rate['decode'][0]:.1f}; device "
            f"busy {busy['batched'][1]:.1%} of a batched pass "
            f"({busy['batched'][0] * 1e3:.2f} ms of kernels), "
            f"{busy['per file'][1]:.1%} of a per-file one "
            f"({busy['per file'][0] * 1e3:.2f} ms; torch.profiler)")
    SUMMARY[f"features {dtype}"] = line
    print(f"{line} on {gpu_line()}", flush=True)


def phase_hub(tmp: str, runs: dict, dev: torch.device) -> None:
    """cpc_audio(pretrained=True) from a {"config", "weights"} file written
    from the bf16 run's export, on cuda:0: the features of load_model."""
    from cpc_audio_tpu_torch import hub
    from cpc_audio_tpu_torch.feature_loader import load_model
    out = runs["bfloat16"]
    exported = os.path.join(out, "checkpoint_0.torch.pt")
    with open(os.path.join(out, "checkpoint_args.json")) as f:
        config = json.load(f)
    path = os.path.join(tmp, "pretrained.pt")
    torch.save({"config": config, "weights": torch.load(
        exported, weights_only=True)["gEncoder"]}, path)
    model = hub.cpc_audio(pretrained=True, checkpoint_path=path)
    if next(model.parameters()).device != dev:
        fail("the hub's model is not on cuda:0")
    batch = torch.from_numpy(synthetic_audio(20480, 4, SEED + 17)).to(dev)
    got = model_features(model, batch)
    want = model_features(load_model([exported])[0], batch)
    print(f"hub cpc_audio(pretrained=True) against load_model of the "
          f"export: bit-identical {torch.equal(got, want)}", flush=True)
    if not torch.equal(got, want):
        fail("the hub's features differ from load_model's")


def phone_labels(db: str, path: str, n_phones: int = 20) -> None:
    """Synthetic frame-aligned labels (runs of 2-12 frames) for every WAV
    under ``db``, one line a file."""
    rng = np.random.default_rng(SEED + 23)
    with open(path, "w") as f:
        for d, _, names in sorted(os.walk(db)):
            for name in sorted(names):
                if not name.endswith(".wav"):
                    continue
                with wave.open(os.path.join(d, name)) as w:
                    frames = w.getnframes() // 160
                runs = rng.integers(2, 13, size=frames)
                lab = np.repeat(rng.integers(0, n_phones, size=frames),
                                runs)[:frames]
                f.write(os.path.splitext(name)[0] + " "
                        + " ".join(map(str, lab)) + "\n")


def phase_supervised(tmp: str, db: str, dev: torch.device) -> None:
    """One CLI epoch each of --supervised --pathPhone, the same with --CTC
    and --supervised alone (speaker) in bf16: finite losses, K1's forward
    and backward counted; then the phone probe at the CLI's default float32,
    whose first step is held against the same step on the CPU."""
    from cpc_audio_tpu_torch import train
    phones = os.path.join(tmp, "phones.txt")
    phone_labels(db, phones)
    k1 = ("lstm_fwd", "lstm_bwd")
    for extra in (["--pathPhone", phones], ["--pathPhone", phones, "--CTC"],
                  []):
        out = os.path.join(tmp, f"supervised_{len(extra)}")
        what = "--supervised " + " ".join(
            "<labels>" if e == phones else e for e in extra)
        _run_cli(train, default_argv(db, out, "bfloat16", "--supervised",
                                     *extra), what, k1)
        with open(os.path.join(out, "checkpoint_logs.json")) as f:
            logs = json.load(f)
        loss = np.asarray(logs["locLoss_train"], np.float64)
        acc = np.asarray(logs["locAcc_train"], np.float64)
        print(f"train CLI {what}: train loss {loss.ravel().round(4)}, "
              f"acc {acc.ravel().round(4)}", flush=True)
        if loss.shape != (1, 1) or not np.isfinite(loss).all():
            fail(f"train CLI {what}: losses {loss}")
    results, relu, tails = [], {}, []
    with cli_first_step_on_cpu(dev, results, relu, tails):
        _run_cli(train, default_argv(
            db, os.path.join(tmp, "supervised_f32"), "float32",
            "--supervised", "--pathPhone", phones),
            "--supervised --pathPhone <labels> --compute_dtype float32", k1)
    if len(results) != 2:
        fail(f"the phone probe's first step ran {len(results)} times, not "
             f"on the card and on the CPU")
    compare_train_steps("train CLI phone probe", results, relu, tails)


def phase_interchange(tmp: str, dev: torch.device):
    """Checkpoint interchange, lane-packed features, the hub and the
    supervised criteria at the default architecture, on phase_cli's WAV
    tree; returns the K1 launches of the bf16 batched features and the
    export runs' directories by dtype."""
    db = os.path.join(tmp, "db")
    t0 = time.time()
    runs = phase_export(tmp, db, dev)
    launches = phase_features(tmp, runs, dev)
    phase_hub(tmp, runs, dev)
    phase_supervised(tmp, db, dev)
    print(f"[phase interchange {time.time() - t0:.1f} s]", flush=True)
    return launches, runs


# ---------------------------------------------------------------------------
# The eval CLIs (cpc_audio_tpu_torch.eval) on the default architecture
# ---------------------------------------------------------------------------

class _Recorder:
    """Stands in for a kernel's wrapper ``fn`` (K1's while a CLI runs, K2's
    and K5's on the long-window paths): records the shape of each call on
    the card in ``calls`` and calls the wrapper.  The wrapper counts
    through its module's name, which then names this object, so
    ``launches`` and ``body_launches`` are the wrapper's own."""

    def __init__(self, fn, shape_of):
        self.fn, self.shape_of, self.calls = fn, shape_of, []

    def __call__(self, first, *args, **kwargs):
        if first.is_cuda:
            self.calls.append(self.shape_of(first, *args, **kwargs))
        return self.fn(first, *args, **kwargs)

    launches = property(lambda self: self.fn.launches,
                        lambda self, n: setattr(self.fn, "launches", n))
    body_launches = property(lambda self: self.fn.body_launches)


@contextlib.contextmanager
def recorded(module, shapes: dict):
    """While the block runs: ``shape_of(*args)`` of each call on the card
    of each of ``module``'s wrappers ``name`` in ``shapes`` (name:
    shape_of; a _Recorder stands in for each), their calls and counts
    unchanged."""
    recs = {n: _Recorder(getattr(module, n), f) for n, f in shapes.items()}
    for n, r in recs.items():
        setattr(module, n, r)
    try:
        yield {n: r.calls for n, r in recs.items()}
    finally:
        for n, r in recs.items():
            setattr(module, n, r.fn)


@contextlib.contextmanager
def k1_calls():
    """While a CLI runs: the shape of each K1 call on the card, (B, T, H,
    residuals) of every forward and (B, T, H) of every backward; the calls
    and their counts unchanged."""
    from cpc_audio_tpu_torch.ops import lstm
    with recorded(lstm, {
            "lstm_fwd": lambda x_proj, w_hh, h0, c0, save_residuals=False:
            (*x_proj.shape[:2], h0.shape[-1], save_residuals),
            "lstm_bwd": lambda gates, *args: (*gates.shape[:2],
                                              gates.shape[-1] // 4)}) as c:
        yield {"fwd": c["lstm_fwd"], "bwd": c["lstm_bwd"]}


def run_eval_cli(main, argv, what: str):
    """One eval CLI on the card, its output captured: (seconds, output
    lines, K1 calls by shape), the calls recorded held to the wrappers'
    launch counts and the run's K1 bodies checked to be the cluster ones
    at --hiddenGar 256."""
    fns = reset_counts()
    log = io.StringIO()
    t0 = time.perf_counter()
    with k1_calls() as calls, contextlib.redirect_stdout(log):
        rc = main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    lines = log.getvalue().splitlines()
    if rc != 0:
        fail(f"{what} exited {rc}: {lines[-20:]}")
    for n, d in (("lstm_fwd", "fwd"), ("lstm_bwd", "bwd")):
        got = dict(fns[n].body_launches)
        if sum(got.values()) != got["cluster"] or \
                fns[n].launches != got["cluster"]:
            fail(f"{what}: {n} ran bodies {got}, not the cluster body alone")
        if len(calls[d]) != fns[n].launches:
            fail(f"{what}: {len(calls[d])} {n} calls recorded on the card, "
                 f"{fns[n].launches} launches counted")
    print(f"{what}: rc 0 in {secs:.2f} s; K1 forward calls (B, T, H, "
          f"residuals): {dict(Counter(calls['fwd']))}, backward calls: "
          f"{dict(Counter(calls['bwd']))}", flush=True)
    return secs, lines, calls


@contextlib.contextmanager
def step_on_cpu_too(module, factory: str, losses_of, results: list,
                    relu: dict, tails: list):
    """While a CLI of ``module`` runs: the first call of the train step
    that ``module.<factory>`` makes (validation steps, ``train=False``,
    aside) runs as it is on the card and, from a copy of the state taken
    just before, on the CPU with the same arguments; each run's losses
    (``losses_of(output)``) and gradients go to ``results`` (card first),
    the encoder's ReLU inputs to ``relu`` and the heads' K3 inputs to
    ``tails``, for compare_train_steps."""
    from cpc_audio_tpu_torch.parallel.train_step import create_train_state
    original = getattr(module, factory)

    def cpu(x):
        if isinstance(x, torch.Tensor):
            return x.cpu()
        if isinstance(x, (tuple, list)):
            return type(x)(cpu(t) for t in x)
        return x

    def spy(state, device, *a, **kw):
        step = original(state, device, *a, **kw)
        if not kw.get("train", True):
            return step

        def first(*args, **skw):
            if results:
                return step(*args, **skw)
            cpu_state = create_train_state(
                copy.deepcopy(state.model).cpu(),
                copy.deepcopy(state.criterion).cpu(), "cpu")
            out = None
            for st, run, ar, k in ((state, step, args, skw),
                                   (cpu_state,
                                    original(cpu_state, "cpu", *a, **kw),
                                    cpu(args), {n: cpu(v) for n, v in
                                                skw.items()})):
                with record_tail_inputs() as tail, \
                        encoder_relu_kinks(st.model, relu):
                    o = run(*ar, **k)
                tails.append(tail)
                results.append((losses_of(o).float().cpu().reshape(-1),
                                step_grads(st)))
                out = o if out is None else out
            return out
        return first

    setattr(module, factory, spy)
    try:
        yield
    finally:
        setattr(module, factory, original)


def k1_count(calls: dict, shape, residuals=None) -> int:
    """Calls at (B, T, H) ``shape``: forwards with (True) or without
    (False) residuals, or backwards (None)."""
    if residuals is None:
        return sum(1 for c in calls["bwd"] if c == shape)
    return sum(1 for c in calls["fwd"] if c == (*shape, residuals))


def eval_lists(tmp: str, paths: list) -> dict:
    """Train / val / all lists (file stems) over the ragged tree: val the
    last file of each speaker, train the rest (the 9 s file among them)."""
    stems = [os.path.splitext(os.path.basename(p))[0] for p in paths]
    val = stems[-FEATURE_SPEAKERS:]
    lists = {}
    for name, part in (("train", [s for s in stems if s not in val]),
                       ("val", val), ("all", stems)):
        lists[name] = os.path.join(tmp, f"eval_{name}.txt")
        with open(lists[name], "w") as f:
            f.write("\n".join(part) + "\n")
    return lists


def phase_probes(tmp: str, db: str, lists: dict, runs: dict,
                 launches: dict) -> str:
    """linear_separability on the ragged tree: one bf16 epoch each of the
    frozen speaker probe, the frozen phone probe and --unfrozen --CTC;
    finite losses; K1's forward without residuals and no backward when
    frozen, with residuals and the backward unfrozen (cluster bodies);
    then the unfrozen speaker probe in float32, its first step held
    against the CPU.  Returns the frozen phone probe's checkpoint."""
    from cpc_audio_tpu_torch.eval import linear_separability as tls
    phones = os.path.join(tmp, "eval_phones.txt")
    phone_labels(db, phones)
    shape = EVAL_SHAPES[0][1:]
    probe_ckpt = None
    for i, (what, extra) in enumerate((
            ("frozen speaker", []), ("frozen phone", ["--pathPhone", phones]),
            ("--unfrozen --CTC", ["--unfrozen", "--CTC", "--pathPhone",
                                  phones]))):
        out = os.path.join(tmp, f"probe_{i}")
        secs, _, calls = run_eval_cli(tls.main, [
            db, lists["train"], lists["val"],
            os.path.join(runs["bfloat16"], "checkpoint_0.pt"),
            "--pathCheckpoint", out, "--file_extension", ".wav",
            "--n_epoch", "1", "--ignore_cache", "--random_seed",
            str(SEED)] + extra, f"linear_separability {what}")
        frozen = "--unfrozen" not in extra
        with open(os.path.join(out, "checkpoint_logs.json")) as f:
            logs = json.load(f)
        loss = np.asarray(logs["locLoss_train"] + logs["locLoss_val"],
                          np.float64)
        train_fwd = k1_count(calls, shape, True)
        infer_fwd = k1_count(calls, shape, False)
        bwd = k1_count(calls, shape)
        windows = 8 * (train_fwd + infer_fwd)
        line = (f"linear_separability {what}, bf16: {secs:.2f} s for one "
                f"epoch ({windows} windows of 20480 samples, train and val: "
                f"{windows / secs:.1f} windows/s, host clock, loading "
                f"included); losses {loss.ravel().round(4)}")
        SUMMARY[f"probe {what}"] = line
        print(line, flush=True)
        if not np.isfinite(loss).all():
            fail(f"linear_separability {what}: losses {loss}")
        if frozen and (train_fwd or bwd or not infer_fwd
                       or len(calls["fwd"]) != infer_fwd):
            fail(f"the frozen probe ran K1 with residuals or its backward: "
                 f"{calls}")
        if not frozen and not (train_fwd and bwd == train_fwd):
            fail(f"the unfrozen probe ran no K1 train forward and backward "
                 f"at {shape}: {calls}")
        if frozen:
            launches["lstm_fwd_probe_inference"] = \
                launches.get("lstm_fwd_probe_inference", 0) + infer_fwd
        else:
            launches["lstm_fwd_probe"], launches["lstm_bwd_probe"] = \
                train_fwd, bwd
        if what == "frozen phone":
            probe_ckpt = os.path.join(out, "checkpoint_0.pt")
    # the load of the phone probe's directory
    from cpc_audio_tpu_torch.feature_loader import load_supervised_criterion
    crit, n_phones = load_supervised_criterion(probe_ckpt)
    print(f"load_supervised_criterion of the phone probe: "
          f"{type(crit).__name__}, {n_phones} phones", flush=True)
    results, relu, tails = [], {}, []
    with step_on_cpu_too(tls, "make_probe_step", lambda o: o["losses"],
                         results, relu, tails):
        run_eval_cli(tls.main, [
            db, lists["train"], lists["val"],
            os.path.join(runs["float32"], "checkpoint_0.pt"),
            "--pathCheckpoint", os.path.join(tmp, "probe_f32"),
            "--file_extension", ".wav", "--n_epoch", "1", "--ignore_cache",
            "--unfrozen", "--random_seed", str(SEED)],
            "linear_separability --unfrozen, float32")
    if len(results) != 2:
        fail(f"the unfrozen probe's first step ran {len(results)} times")
    compare_train_steps("unfrozen speaker probe", results, relu, tails)
    return probe_ckpt


def abx_item_file(db: str, path: str) -> None:
    """A ZeroSpeech .item file over every WAV under ``db``: back-to-back
    segments of 50-150 ms, each of one of 4 phones between 2 x 2
    contexts, the speaker its directory's, so that within- and
    across-speaker groups both exist."""
    rng = np.random.default_rng(SEED + 31)
    lines = ["#file onset offset #phone prev-phone next-phone speaker"]
    for d, _, names in sorted(os.walk(db)):
        for name in sorted(n for n in names if n.endswith(".wav")):
            with wave.open(os.path.join(d, name)) as w:
                dur = w.getnframes() / 16000
            t = 0.05
            while t + 0.2 < dur:
                step = float(rng.uniform(0.05, 0.15))
                lines.append(f"{os.path.splitext(name)[0]} {t:.3f} "
                             f"{t + step:.3f} p{rng.integers(4)} "
                             f"c{rng.integers(2)} c{rng.integers(2)} "
                             f"{os.path.basename(d)}")
                t += step
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


class _Groups:
    """An ABX group iterator's groups, kept to be scored several times."""

    def __init__(self, it):
        self.groups, self.symmetric = list(it), it.symmetric
        self.board = it.get_board_size()

    def __iter__(self):
        return iter(self.groups)

    def get_board_size(self):
        return self.board


def abx_scoring_times(db: str, item: str, ckpt: str,
                      dev: torch.device) -> None:
    """ABX's scoring alone (cosine distances, DTW, theta; no extraction)
    over the within and across groups of the CLI runs (their defaults:
    groups of up to 10, 5 x across, seed 0) on ``ckpt``'s per-file
    features: on the card (_scores_on_device), with the native host DTW
    where its library loads, and with the host DTW in Python, in turns
    (each way, then back in reverse order); host clock, the card's run
    read back in full; each host way's scores within 1e-5 of the card's."""
    from cpc_audio_tpu_torch.eval.abx import group_computation as abx_g
    from cpc_audio_tpu_torch.eval.abx import iterators as abx_it
    from cpc_audio_tpu_torch.feature_loader import (FeatureModule,
                                                    build_feature,
                                                    load_model)
    from cpc_audio_tpu_torch.ops import native
    fm = FeatureModule(load_model([ckpt])[0], keep_hidden=True)
    seqs = [(os.path.splitext(os.path.basename(p))[0], p) for p in
            sorted(glob.glob(os.path.join(db, "*", "*.wav")))]
    data = abx_it.ABXFeatureLoader(item, seqs, lambda x: build_feature(fm, x),
                                   100.0, True)
    groups = [_Groups(abx_it.ABXWithinGroupIterator(data, 10)),
              _Groups(abx_it.ABXAcrossGroupIterator(data, 10, max_x=5))]
    pairs = sum(len(x[0]) * (len(a[0]) + len(b[0]))
                for g in groups for _, a, b, x in g.groups)
    ways = ["card"] + (["native"] if native.available() else []) \
        + ["python"]
    available = native.available

    def score(way):
        native.available = (lambda: False) if way == "python" else available
        try:
            return [abx_g.get_abx_scores_dtw_on_group(
                g, abx_g.get_cosine_distance_batch, g.symmetric,
                on_device=way == "card", device=dev)[1] for g in groups]
        finally:
            native.available = available
    secs, values = {w: [] for w in ways}, {}
    for way in ways + ways[::-1]:
        t0 = time.perf_counter()
        values[way] = np.concatenate(score(way))
        secs[way].append(time.perf_counter() - t0)
    err = {w: float(np.abs(values[w] - values["card"]).max())
           for w in ways[1:]}
    line = (f"ABX scoring alone, {len(groups[0].groups)} within + "
            f"{len(groups[1].groups)} across groups, {pairs} DTW pairs, "
            f"{os.cpu_count()} host cores, torch threads "
            f"{torch.get_num_threads()}, in turns (host clock): "
            + "; ".join(f"{w} {secs[w][0]:.3f} / {secs[w][1]:.3f} s"
                        for w in ways)
            + f"; the host ways' scores against the card's: max |err| {err}")
    SUMMARY["abx scoring"] = line
    print(line, flush=True)
    if max(err.values()) > 1e-5:
        fail("ABX scoring on the card disagrees with the host DTW")
    del fm
    torch.cuda.empty_cache()


def phase_abx(tmp: str, db: str, runs: dict, dev: torch.device) -> None:
    """abx_cli from_checkpoint on the bf16 run: lane-packed (8 lanes), then
    --strict, then --on_device (lane-packed features, the DTW on the
    card); within and across in [0, 1], --on_device within 1e-5 of the
    host DTW's; the seconds of each mode; then the scoring alone
    (abx_scoring_times)."""
    from cpc_audio_tpu_torch.eval import abx_cli
    item = os.path.join(tmp, "eval.item")
    abx_item_file(db, item)
    ckpt = os.path.join(runs["bfloat16"], "checkpoint_0.pt")
    scores, secs = {}, {}
    for mode, extra in (("batched", []), ("strict", ["--strict"]),
                        ("on_device", ["--on_device"])):
        out = os.path.join(tmp, f"abx_{mode}")
        secs[mode], _, calls = run_eval_cli(abx_cli.main, [
            "from_checkpoint", ckpt, item, db, "--file_extension", ".wav",
            "--out", out] + extra, f"abx_cli from_checkpoint ({mode})")
        if any(c[3] for c in calls["fwd"]) or calls["bwd"]:
            fail(f"abx_cli ({mode}) ran K1 with residuals or backward")
        with open(os.path.join(out, "ABX_scores.json")) as f:
            scores[mode] = json.load(f)
        if set(scores[mode]) != {"within", "across"} or not all(
                0.0 <= v <= 1.0 for v in scores[mode].values()):
            fail(f"abx_cli ({mode}) scores {scores[mode]}")
    err = max(abs(scores["on_device"][k] - scores["batched"][k])
              for k in ("within", "across"))
    from cpc_audio_tpu_torch.ops import native
    line = (f"abx_cli from_checkpoint, bf16, 12 files of 3-9 s (the host "
            f"DTW {'native' if native.available() else 'in Python'}): "
            f"seconds "
            f"(host clock, extraction included) batched {secs['batched']:.2f}"
            f", strict {secs['strict']:.2f}, on_device "
            f"{secs['on_device']:.2f}; scores {scores}; --on_device against "
            f"the host DTW: max |err| {err:.3e}")
    SUMMARY["abx"] = line
    print(line, flush=True)
    if err > 1e-5:
        fail("abx --on_device disagrees with the host DTW")
    abx_scoring_times(db, item, ckpt, dev)


def phase_zerospeech(tmp: str, db: str, runs: dict, probe_ckpt: str) -> None:
    """build_zerospeech_features on the bf16 run: fea lane-packed, then
    npy --strict --seqNorm, each file against per-file build_feature (the
    lanes within FEATURE_ATOL, the strict per-file path exactly), then
    --addCriterion with the phone probe against ModelPhoneCombined."""
    from cpc_audio_tpu_torch.eval import build_zerospeech_features as tzs
    from cpc_audio_tpu_torch.feature_loader import (FeatureModule,
                                                    ModelPhoneCombined,
                                                    build_feature,
                                                    load_model,
                                                    load_supervised_criterion)
    ckpt = os.path.join(runs["bfloat16"], "checkpoint_0.pt")
    model = load_model([ckpt])[0]
    paths = sorted(glob.glob(os.path.join(db, "*", "*.wav")))
    combined = ModelPhoneCombined(FeatureModule(load_model([probe_ckpt])[0]),
                                  load_supervised_criterion(probe_ckpt)[0])
    for fmt, extra, ckpt_, maker, kw, atol in (
            ("fea", [], ckpt, FeatureModule(model), {},
             FEATURE_ATOL["bfloat16"]),
            ("npy", ["--strict", "--seqNorm"], ckpt, FeatureModule(model),
             {"strict": True, "seq_norm": True}, 0.0),
            ("npy", ["--addCriterion"], probe_ckpt, combined, {}, 0.0)):
        out = os.path.join(tmp, f"zs_{fmt}_{len(extra)}")
        secs, _, _ = run_eval_cli(tzs.main, [db, out, ckpt_, "--format", fmt]
                                  + extra, f"build_zerospeech_features "
                                  f"{fmt} {' '.join(extra)}")
        worst, same = 0.0, True
        for p in paths:
            want = build_feature(maker, p, **kw)[0]
            f = os.path.join(out, os.path.splitext(os.path.basename(p))[0]
                             + f".{fmt}")
            if fmt == "npy":
                got = np.load(f)
            else:
                with open(f) as fh:
                    got = np.fromstring(fh.read(), sep=" ").reshape(
                        want.shape[0], -1)[:, 1:].astype(np.float32)
            if got.shape != want.shape or not np.isfinite(got).all():
                fail(f"zerospeech {fmt} {extra}: {f} {got.shape}, not "
                     f"{want.shape}")
            worst = max(worst, float(np.abs(got - want).max()))
            same = same and np.array_equal(got, want)
        line = (f"build_zerospeech_features --format {fmt} "
                f"{' '.join(extra)}, bf16: {secs:.2f} s for 12 files; "
                f"against per-file build_feature: max |err| {worst:.3e} "
                f"(tolerance {atol:g}), bit-identical {same}")
        SUMMARY[f"zerospeech {fmt} {len(extra)}"] = line
        print(line, flush=True)
        if worst > atol:
            fail(f"build_zerospeech_features {fmt} {extra} disagrees with "
                 f"build_feature")
    del model, combined
    torch.cuda.empty_cache()


def cv_phones(db: str, path: str, n_phones: int = 20) -> None:
    """Phone sequences for every WAV under ``db`` (a phone every 25
    frames, none twice in a row), as Common Voice's transcriptions."""
    rng = np.random.default_rng(SEED + 41)
    with open(path, "w") as f:
        for d, _, names in sorted(os.walk(db)):
            for name in sorted(n for n in names if n.endswith(".wav")):
                with wave.open(os.path.join(d, name)) as w:
                    n = w.getnframes() // 160 // 25
                seq = np.cumsum(rng.integers(1, n_phones, size=n)) % n_phones
                f.write(os.path.splitext(name)[0] + " "
                        + " ".join(map(str, seq)) + "\n")


def phase_common_voices(tmp: str, db: str, lists: dict, runs: dict,
                        launches: dict) -> None:
    """common_voices train (2 epochs, --LSTM, fine-tuned, bf16, batch 8;
    K1 forward with residuals and backward at B 8 / T 900, the model's and
    the head's), train --freeze (1 epoch, no --LSTM: K1's forward without
    residuals and no backward) and per over all 12 files (K1's forward
    without residuals at B 8 / T 900); finite losses, a finite,
    non-negative PER; then a float32 train whose first step is held
    against the CPU."""
    from cpc_audio_tpu_torch.eval import common_voices as tcv
    phones = os.path.join(tmp, "cv_phones.txt")
    cv_phones(db, phones)
    shape = EVAL_SHAPES[1][1:]
    out = os.path.join(tmp, "cv")
    secs, lines, calls = run_eval_cli(tcv.main, [
        "train", db, phones, os.path.join(runs["bfloat16"], "checkpoint_0.pt"),
        "--file_extension", ".wav", "--LSTM", "--nEpochs", "2",
        "--batchSize", "8", "--pathTrain", lists["train"], "--pathVal",
        lists["val"], "-o", out, "--seed", str(SEED)],
        "common_voices train --LSTM, bf16")
    losses = [float(ln.split(":")[-1]) for ln in lines if " loss " in ln]
    train_fwd, bwd = k1_count(calls, shape, True), k1_count(calls, shape)
    if len(losses) != 4 or not np.isfinite(losses).all():
        fail(f"common_voices train: losses {losses}")
    if not train_fwd or bwd != train_fwd:
        fail(f"common_voices train ran no K1 train forward and backward at "
             f"{shape}: {calls}")
    launches["lstm_fwd_cv"], launches["lstm_bwd_cv"] = train_fwd, bwd
    freeze_secs, lines, calls = run_eval_cli(tcv.main, [
        "train", db, phones, os.path.join(runs["bfloat16"], "checkpoint_0.pt"),
        "--file_extension", ".wav", "--freeze", "--nEpochs", "1",
        "--batchSize", "8", "--pathTrain", lists["train"], "--pathVal",
        lists["val"], "-o", os.path.join(tmp, "cv_freeze"), "--seed",
        str(SEED)], "common_voices train --freeze, bf16")
    freeze_losses = [float(ln.split(":")[-1]) for ln in lines
                     if " loss " in ln]
    freeze_fwd = k1_count(calls, shape, False)
    if len(freeze_losses) != 2 or not np.isfinite(freeze_losses).all():
        fail(f"common_voices train --freeze: losses {freeze_losses}")
    if calls["bwd"] or any(c[3] for c in calls["fwd"]) or not freeze_fwd:
        fail(f"common_voices train --freeze ran K1 with residuals or its "
             f"backward, or no forward at {shape}: {calls}")
    per_secs, lines, calls = run_eval_cli(tcv.main, [
        "per", out, "--batchSize", "8", "--pathVal", lists["all"],
        "--pathPhone", phones], "common_voices per")
    per = [float(ln.split()[-1]) for ln in lines
           if ln.startswith("Average PER")]
    infer = k1_count(calls, shape, False)
    if len(per) != 1 or not np.isfinite(per[0]) or per[0] < 0 or not infer \
            or any(c[3] for c in calls["fwd"]):
        fail(f"common_voices per: PER {per}, K1 calls {calls}")
    launches["lstm_fwd_cv_inference"] = infer + freeze_fwd
    line = (f"common_voices, bf16, batch 8, 9 train / 3 val utterances of "
            f"3-9 s padded to 9 s: train --LSTM, fine-tuned (2 epochs) "
            f"{secs:.2f} s, losses {np.round(losses, 4).tolist()}; train "
            f"--freeze (1 epoch) {freeze_secs:.2f} s, losses "
            f"{np.round(freeze_losses, 4).tolist()}, K1 forwards without "
            f"residuals {freeze_fwd}, no backward; per over 12 utterances "
            f"{per_secs:.2f} s (the spawn pool's start included), average "
            f"PER {per[0]:.4f} (host clock)")
    SUMMARY["common_voices"] = line
    print(line, flush=True)
    results, relu, tails = [], {}, []
    with step_on_cpu_too(tcv, "make_train_step", lambda o: o, results, relu,
                         tails):
        run_eval_cli(tcv.main, [
            "train", db, phones,
            os.path.join(runs["float32"], "checkpoint_0.pt"),
            "--file_extension", ".wav", "--LSTM", "--nEpochs", "1",
            "--batchSize", "2", "--pathTrain", lists["train"], "--pathVal",
            lists["val"], "-o", os.path.join(tmp, "cv_f32"), "--seed",
            str(SEED)], "common_voices train --LSTM, float32, batch 2")
    if len(results) != 2:
        fail(f"common_voices' first step ran {len(results)} times")
    compare_train_steps("common_voices fine-tuning", results, relu, tails)


def phase_resample(tmp: str) -> None:
    """adjust_sample_rate over 3 WAVs of 44.1 kHz tones, 2 of them with a
    phone transcription: 2 WAVs out, 16-bit at 16 kHz, of ceil(n * 160 /
    441) samples, each within 2e-3 of its tone sampled at 16 kHz 200
    samples away from the ends (resample_poly's filter; the 16-bit
    rounding is 3e-5)."""
    from cpc_audio_tpu_torch.eval import adjust_sample_rate as tasr
    src, out = os.path.join(tmp, "asr_in"), os.path.join(tmp, "asr_out")
    os.makedirs(src)
    tones = {"clip_a": (440.0, 1.0), "clip_b": (1000.0, 1.5),
             "clip_c": (3000.0, 2.0)}
    for name, (f, dur) in tones.items():
        t = np.arange(int(44100 * dur)) / 44100
        _write_wav(os.path.join(src, name + ".wav"),
                   0.5 * np.sin(2 * np.pi * f * t), 44100)
    listed = os.path.join(tmp, "asr_list.tsv")
    with open(listed, "w") as fh:
        fh.write("clip_a\tp1 p2\nclip_c\tp3\n")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = tasr.main([src, listed, out, "--file_extension", ".wav"])
    secs = time.perf_counter() - t0
    if rc != 0 or sorted(os.listdir(out)) != ["clip_a.wav", "clip_c.wav"]:
        fail(f"adjust_sample_rate: rc {rc}, wrote {os.listdir(out)}")
    worst = 0.0
    for name in ("clip_a", "clip_c"):
        f, dur = tones[name]
        with wave.open(os.path.join(out, name + ".wav")) as w:
            rate, width = w.getframerate(), w.getsampwidth()
            y = np.frombuffer(w.readframes(w.getnframes()), "<i2") / 32767
        n = int(44100 * dur)
        if rate != 16000 or width != 2 or len(y) != -(-n * 160 // 441):
            fail(f"adjust_sample_rate {name}: {rate} Hz, {width} bytes, "
                 f"{len(y)} samples")
        want = 0.5 * np.sin(2 * np.pi * f * np.arange(len(y)) / 16000)
        worst = max(worst, float(np.abs(y - want)[200:-200].max()))
    line = (f"adjust_sample_rate, 2 of 3 WAVs 44.1 -> 16 kHz: {secs:.2f} s; "
            f"against the tones: max |err| {worst:.3e} (tolerance 2e-3)")
    SUMMARY["adjust_sample_rate"] = line
    print(line, flush=True)
    if worst > 2e-3:
        fail("adjust_sample_rate's output is not the resampled tone")


def phase_eval_clis(tmp: str, runs: dict, dev: torch.device) -> dict:
    """The port's eval CLIs on phase_interchange's default-architecture
    runs (bf16, and the CLIs' default float32 where a step is held against
    the CPU), over phase_features' ragged tree of 12 WAVs of 3-9 s in 3
    speaker directories: linear separability, ABX, the ZeroSpeech
    features, resampling and Common Voice; returns the K1 launches at
    EVAL_SHAPES by JSON entry."""
    t0 = time.time()
    db = os.path.join(tmp, "features")
    paths = sorted(glob.glob(os.path.join(db, "*", "*.wav")),
                   key=os.path.basename)
    lists = eval_lists(tmp, paths)
    launches = {}
    probe_ckpt = phase_probes(tmp, db, lists, runs, launches)
    phase_abx(tmp, db, runs, dev)
    phase_zerospeech(tmp, db, runs, probe_ckpt)
    phase_resample(tmp)
    phase_common_voices(tmp, db, lists, runs, launches)
    for name in SOURCES:
        if name.startswith("lstm_") and name.endswith(
                ("_probe", "_cv", "_inference")) \
                and launches.get(name, 0) <= 0:
            fail(f"the eval CLIs launched no {name}")
    print(f"[phase eval CLIs {time.time() - t0:.1f} s]", flush=True)
    return launches


# ---------------------------------------------------------------------------
# The non-default variants (phase_variants)
# ---------------------------------------------------------------------------

# CPCConfig fields of each variant train path beside the default config
# (--arMode LSTM, 256 channels, --sizeWindow 20480, 12 heads)
VARIANT_PATHS = {
    "LSTM heads": {"rnnMode": "LSTM", "cpc_mode": "reverse",
                   "speakerEmbedding": 16, "normMode": "batchNorm"},
    "ffd mfcc": {"rnnMode": "ffd", "encoder_type": "mfcc"},
    "conv8 lfb": {"rnnMode": "conv8", "encoder_type": "lfb"},
    "linear instanceNorm": {"rnnMode": "linear",
                            "normMode": "instanceNorm"},
    "RNN ID": {"rnnMode": "RNN", "normMode": "ID"},
    "none": {"cpc_mode": "none"},
}
HEADS_PATH = "LSTM heads"
N_SPEAKERS = 8            # the speaker embedding's table


def variant_build(path: str, dtype: str, generator: torch.Generator):
    """Model and criterion of variant ``path`` (VARIANT_PATHS), the
    fused-layer switches off."""
    from cpc_audio_tpu_torch.config import CPCConfig
    from cpc_audio_tpu_torch.criterion import build_criterion
    from cpc_audio_tpu_torch.models import build_model
    with switches(path):
        model = build_model(CPCConfig(compute_dtype=dtype,
                                      **VARIANT_PATHS[path]), generator)
        crit = build_criterion(model.config, generator,
                               n_speakers=N_SPEAKERS)
    return model, crit


def speaker_labels(B: int) -> torch.Tensor:
    """A synthetic speaker id for each window of a batch."""
    return torch.arange(B) % N_SPEAKERS


@contextlib.contextmanager
def k4_calls():
    """As k1_calls, for K4: (B, T, H, residuals) of every forward and (B,
    T, H) of every backward on the card."""
    from cpc_audio_tpu_torch.ops import gru
    with recorded(gru, {
            "gru_fwd": lambda x_proj, w_hh, b_hh, h0, save_residuals=False:
            (*x_proj.shape[:2], h0.shape[-1], save_residuals),
            "gru_bwd": lambda gates, ghn, h0, ys, *args: (
                *ys.shape[:2], ys.shape[-1])}) as c:
        yield {"fwd": c["gru_fwd"], "bwd": c["gru_bwd"]}


def variant_train(dev: torch.device, path: str, B: int = 32,
                  steps: int = 3) -> dict:
    """``steps`` bf16 train steps of variant ``path`` on a fixed batch:
    finite losses (under --cpc_mode none one zero each, and the
    parameters unchanged), the AR's K1 each step, train windows/s (the
    median of the steps after the first); on HEADS_PATH K1 12 + 12 times
    a step at the heads' (B, W, hiddenEncoder), on its cluster bodies,
    and the step's profile.  Returns the heads' K1 launches."""
    model, crit = variant_build(path, "bfloat16",
                                torch.Generator().manual_seed(SEED))
    cfg = model.config
    step, batch, key = train_setup(model, crit, dev, B)
    labels = speaker_labels(B) if cfg.speakerEmbedding else None
    before = {n: p.detach().clone() for n, p in
              list(model.named_parameters()) + list(crit.named_parameters())}
    fns = reset_counts()
    losses, times = [], []
    with k1_calls() as calls:
        for _ in range(steps):
            t0 = time.perf_counter()
            _, met = step(batch, key=key, labels=labels)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(met["losses"])
    per = torch.stack(losses).float().cpu()
    K = 1 if cfg.cpc_mode == "none" else cfg.nPredicts
    if tuple(per.shape) != (steps, K) or not torch.isfinite(per).all():
        fail(f"{path}: train losses {per.tolist()} not {steps} x {K} "
             f"finite")
    S = cfg.sizeWindow // 160
    ar = (B, S, cfg.hiddenGar)
    if k1_count(calls, ar, True) != steps:
        fail(f"{path}: the AR's K1 forward ran {Counter(calls['fwd'])}")
    if cfg.cpc_mode == "none":
        if per.abs().max() != 0:
            fail(f"{path}: losses {per.tolist()} not zero")
        for n, p in list(model.named_parameters()) + \
                list(crit.named_parameters()):
            if not torch.equal(p.detach(), before[n]):
                fail(f"{path}: the parameter {n} moved")
        print(f"{path}: {steps} steps, losses zero, every parameter "
              f"unchanged", flush=True)
    step_ms = statistics.median(times[1:]) * 1e3
    print(f"{path} train windows/s: {B / (step_ms / 1e3):.1f} "
          f"(make_train_step, {VARIANT_PATHS[path]}, B={B}, bf16, median "
          f"step {step_ms:.3f} ms of {steps - 1} after the first; losses "
          f"{[round(v, 4) for v in per.sum(dim=1).tolist()]}) on "
          f"{gpu_line()}", flush=True)
    if path != HEADS_PATH:
        return {}
    heads = (B, S - cfg.nPredicts, cfg.hiddenEncoder)
    n_fwd, n_bwd = k1_count(calls, heads, True), k1_count(calls, heads)
    print(f"{path}: K1 forward calls (B, T, H, residuals) "
          f"{dict(Counter(calls['fwd']))}, backward calls "
          f"{dict(Counter(calls['bwd']))}", flush=True)
    if n_fwd != cfg.nPredicts * steps or n_bwd != cfg.nPredicts * steps:
        fail(f"{path}: K1 ran {n_fwd} forwards and {n_bwd} backwards at the "
             f"heads' {heads}, not {cfg.nPredicts} x {steps} each")
    for name in ("lstm_fwd", "lstm_bwd"):
        check_body(fns, path, (cfg.nPredicts + 1) * steps, "cluster", name)
    profile_train(lambda b, key=None: step(b, key=key, labels=labels),
                  batch, key, step_ms, path)
    return {"lstm_fwd_heads": n_fwd, "lstm_bwd_heads": n_bwd}


def heads_step_against_cpu(dev: torch.device, steps: int = 2) -> None:
    """HEADS_PATH in float32 on a (2, 1, 20480) batch, two steps, the
    card's (K1 in the heads and the AR) against the CPU's (plain
    versions) from the same weights, keys and speaker labels: the first
    step's losses and gradients (compare_train_steps), then batchNorm's
    running statistics after both."""
    from cpc_audio_tpu_torch.parallel.train_step import (create_train_state,
                                                         epoch_key,
                                                         make_train_step)
    model, crit = variant_build(HEADS_PATH, "float32",
                                torch.Generator().manual_seed(SEED + 4))
    batch = synthetic_audio(model.config.sizeWindow, 2, SEED + 4)
    labels = speaker_labels(2)
    results, tails, relu, stats = [], [], {}, []
    for device in (dev, torch.device("cpu")):
        state = create_train_state(copy.deepcopy(model),
                                   copy.deepcopy(crit), device)
        step = make_train_step(state, device)
        key = epoch_key(SEED, 0, device)
        with record_tail_inputs() as tail, \
                encoder_relu_kinks(state.model, relu):
            _, met = step(batch, key=key, labels=labels)
        tails.append(tail)
        results.append((met["losses"].float().cpu(), step_grads(state)))
        for _ in range(steps - 1):
            step(batch, key=key, labels=labels)
        stats.append({n: b.detach().float().cpu() for n, b in
                      state.model.named_buffers() if "norm" in n})
    # batchNorm removes the bias of the conv before it: that bias's exact
    # gradient is 0, of which each side holds float32 noise; both must be
    # that small beside the convs' weight gradients, and the leaf leaves
    # the leaf-by-leaf comparison
    top = max(g.norm().item() for n, g in results[1][1].items()
              if n.startswith("model.gEncoder.conv") and n.endswith("weight"))
    for i in range(5):
        name = f"model.gEncoder.conv{i}.bias"
        norms = [grads.pop(name).norm().item() for _, grads in results]
        print(f"  {HEADS_PATH} grad {name} (exactly 0 under batchNorm): "
              f"norm card {norms[0]:.3e}, CPU {norms[1]:.3e}, beside the "
              f"largest conv weight gradient's {top:.3e}", flush=True)
        if max(norms) > 1e-5 * top:
            fail(f"{HEADS_PATH}: the gradient of {name} is not 0")
    compare_train_steps(HEADS_PATH, results, relu, tails)
    for name in sorted(stats[1]):
        compare(f"{HEADS_PATH} batchNorm {name} after {steps} steps",
                stats[0][name], stats[1][name], 1e-4, 1e-4,
                "flax's update of float32 batch statistics, the encoder's "
                "convs in another order")


def phase_bidir(dev: torch.device, B: int = 32, T: int = 128, D: int = 256,
                H: int = 256, layers: int = 2) -> dict:
    """BiDIRARTangled and BiDIRAR alone, two layers, D 256 -> 256 (two GRU
    directions of 128), forward and backward on the card in both dtypes
    against float32 on the CPU: K4 forward and backward once a direction a
    layer, on their cluster bodies; outputs and input gradients; the
    device time of a forward and backward.  Returns K4's launches."""
    from cpc_audio_tpu_torch.models import BiDIRAR, BiDIRARTangled
    launches = {"gru_fwd_bidir": 0, "gru_bwd_bidir": 0}
    for cls in (BiDIRARTangled, BiDIRAR):
        g = torch.Generator().manual_seed(SEED + 41)
        ar = cls(D, H, layers, g)
        x = torch.randn(B, T, D, generator=g)
        proj = torch.randn(B, T, H, generator=g)
        xc = x.clone().requires_grad_(True)
        yc, _ = ar(xc)
        (yc * proj).sum().backward()
        card = copy.deepcopy(ar).to(dev)
        for dtype in (torch.bfloat16, torch.float32):
            name = f"{cls.__name__} {str(dtype)[6:]}"
            xg = x.to(dev, dtype).requires_grad_(True)
            pg = proj.to(dev)

            def run():
                y, _ = card(xg)
                (y.float() * pg).sum().backward()
                return y
            fns = reset_counts()
            yg = run()
            torch.cuda.synchronize()
            n = 2 * layers
            for kernel in ("gru_fwd", "gru_bwd"):
                check_body(fns, name, n, "cluster", kernel)
                launches[f"{kernel}_bidir"] += fns[kernel].launches
            rel, why = ((3e-2, "bf16 inputs, weights and outputs through "
                         f"{layers} layers of {T} steps against the float32 "
                         "CPU run") if dtype == torch.bfloat16 else
                        (1e-4, "float32, W_hh on split bf16 planes (3 "
                         "products), sums in another order"))
            compare_norm(f"{name} output", yg.detach().float().cpu(),
                         yc.detach(), rel, why)
            compare_norm(f"{name} input gradient", xg.grad.float().cpu(),
                         xc.grad,
                         rel * 10 if dtype == torch.float32 else rel, why)
            ms = median_ms(lambda: (xg.grad.zero_(), run()), calls=5)
            print(f"{name} B {B} / T {T} / D {D} -> {H}, {layers} layers: "
                  f"forward and backward {ms:.4f} ms (device time a call, "
                  f"K4 {n} + {n} launches and their projections) on "
                  f"{gpu_line()}", flush=True)
            del xg, yg
        del card
    torch.cuda.empty_cache()
    return launches


# the learning gate's tree: GATE_FILES files of GATE_SECONDS s in
# GATE_SPEAKERS speaker directories, the gate's two probe files among them
GATE_FILES, GATE_SECONDS, GATE_SPEAKERS, GATE_PHONES = 24, 6.0, 4, 12


def gate_tree(root: str, seed: int = SEED + 43) -> str:
    """A phone-labelled tree for the learning gate under ``root``: each
    file runs of 2-10 frames (160 samples) of a phone, a phone two tones
    (a low and a high band, each phone its own pair), a speaker its own
    pitch shift, plus noise; 16-bit PCM under the gate's default ``.flac``
    extension (the decoders read WAV by content), the gate's PROBE_TRAIN
    and PROBE_VAL stems first.  Writes the frame labels of every file to
    ``root/phones.txt`` and returns that path."""
    from cpc_audio_tpu_torch.eval.learning_gate import PROBE_TRAIN, PROBE_VAL
    rng = np.random.default_rng(seed)
    stems = PROBE_TRAIN + PROBE_VAL + [
        f"g{i:03d}" for i in range(GATE_FILES - 2)]
    lines = []
    t = np.arange(160) / 16000.0
    for i, stem in enumerate(stems):
        spk = i % GATE_SPEAKERS
        shift = 1.0 + 0.06 * spk
        frames = int(GATE_SECONDS * 100)
        runs = rng.integers(2, 11, size=frames)
        lab = np.repeat(rng.integers(0, GATE_PHONES, size=frames),
                        runs)[:frames]
        phase = rng.uniform(0, 2 * np.pi, size=2)
        x = np.concatenate([
            0.25 * np.sin(2 * np.pi * shift * (250 + 45 * p) * (t + k / 100)
                          + phase[0])
            + 0.15 * np.sin(2 * np.pi * shift * (1100 + 160 * p)
                            * (t + k / 100) + phase[1])
            for k, p in enumerate(lab)])
        x = x + 0.03 * rng.standard_normal(x.shape)
        d = os.path.join(root, f"spk{spk}")
        os.makedirs(d, exist_ok=True)
        _write_wav(os.path.join(d, stem + ".flac"), x)
        lines.append(stem + " " + " ".join(map(str, lab)))
    path = os.path.join(root, "phones.txt")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def phase_gate(tmp: str, dev: torch.device) -> dict:
    """The learning gate (``cpc_audio_tpu_torch.eval.learning_gate``) at
    its defaults on the card, over gate_tree: its JSON line and an exit
    code that agrees with its ``ok``, a CPC loss that fell over its epochs,
    its K4 at the GRU AR's B 8 / T 32 / H 64 forward (with residuals) on
    its resident body and backward on its rows body.  Returns K4's
    launches there."""
    from cpc_audio_tpu_torch.eval import learning_gate
    root = os.path.join(tmp, "gate")
    phones = gate_tree(os.path.join(root, "db"))
    fns = reset_counts()
    log = io.StringIO()
    t0 = time.perf_counter()
    with k4_calls() as calls, contextlib.redirect_stdout(log):
        rc = learning_gate.main(["--pathDB", os.path.join(root, "db"),
                                 "--pathPhone", phones,
                                 "--workdir", os.path.join(root, "work")])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    lines = log.getvalue().splitlines()
    gate = [x for x in lines if x.startswith('{"gate"')]
    if not gate:
        fail(f"the learning gate printed no JSON line: {lines[-20:]}")
    result = json.loads(gate[-1])
    print(f"learning gate (defaults, {GATE_FILES} files of {GATE_SECONDS} "
          f"s): rc {rc} in {secs:.1f} s: {gate[-1]}", flush=True)
    if "error" in result:
        fail(f"the learning gate failed: {result}")
    want = {"gate", "ok", "acc_trained", "acc_random", "delta", "margin",
            "nEpochCPC", "negativeSamplingMode", "workdir"}
    if set(result) != want or rc != (0 if result["ok"] else 1):
        fail(f"the learning gate's result {result} with exit code {rc}")
    # the JAX package's gate does not clear its margin on gate_tree (nor
    # on a second synthetic tree tried) on the CPU (CHANGES.md), so the
    # margin itself waits for the reference fixture (ROADMAP): the run,
    # its JSON line and its exit code are held here, not ``ok``; what the
    # gate's CPC training must move is its loss, each epoch's mean over
    # the heads, on the train and the validation split: the last epoch's
    # below each of the first three (a run that does not learn passes
    # that for both splits about one time in 16)
    with open(os.path.join(root, "work", "cpc", "checkpoint_logs.json")) as f:
        logs = json.load(f)
    fell = {}
    for key in ("locLoss_train", "locLoss_val"):
        means = [float(np.mean(v)) for v in logs[key]]
        fell[key] = (means[0], means[-1])
        if len(means) != result["nEpochCPC"] or \
                not means[-1] < min(means[:3]):
            fail(f"the learning gate's CPC {key} did not fall over its "
                 f"{result['nEpochCPC']} epochs: {means}")
    print(f"learning gate CPC loss, epoch 0 -> {len(means) - 1} (mean over "
          f"heads): " + ", ".join(f"{k} {a:.4f} -> {b:.4f}"
                                  for k, (a, b) in fell.items()), flush=True)
    shape = (8, 32, 64)
    got = {"gru_fwd_gate": k1_count(calls, shape, True),
           "gru_bwd_gate": k1_count(calls, shape)}
    print(f"learning gate K4 forward calls (B, T, H, residuals) "
          f"{dict(Counter(calls['fwd']))}, backward calls "
          f"{dict(Counter(calls['bwd']))}; bodies forward "
          f"{dict(fns['gru_fwd'].body_launches)}, backward "
          f"{dict(fns['gru_bwd'].body_launches)}", flush=True)
    got["gru_fwd_resident"] = fns["gru_fwd"].body_launches["resident"]
    for kernel, want in (("gru_fwd", "resident"), ("gru_bwd", "rows")):
        body = dict(fns[kernel].body_launches)
        if body[want] != fns[kernel].launches or \
                len(calls[kernel[4:]]) != fns[kernel].launches:
            fail(f"the learning gate ran {kernel}'s bodies {body}, "
                 f"{len(calls[kernel[4:]])} calls recorded")
    if min(got.values()) <= 0:
        fail(f"the learning gate launched no K4 at {shape}: {got}")
    return got


def phase_variants(tmp: str, dev: torch.device) -> dict:
    """The non-default variants at full width: the VARIANT_PATHS train
    steps (HEADS_PATH also in float32 against the CPU), the bidirectional
    ARs alone and the learning gate.  Returns the JSON line's launches of
    the VARIANT_SHAPES entries."""
    t0 = time.time()
    launches = {}
    for path in VARIANT_PATHS:
        t1 = time.time()
        launches.update(variant_train(dev, path))
        print(f"[phase variant {path} {time.time() - t1:.1f} s]", flush=True)
    t1 = time.time()
    heads_step_against_cpu(dev)
    print(f"[phase variant {HEADS_PATH} float32 vs CPU "
          f"{time.time() - t1:.1f} s]", flush=True)
    t1 = time.time()
    launches.update(phase_bidir(dev))
    print(f"[phase bidirectional ARs {time.time() - t1:.1f} s]", flush=True)
    t1 = time.time()
    launches.update(phase_gate(tmp, dev))
    print(f"[phase learning gate {time.time() - t1:.1f} s]", flush=True)
    print(f"[phase variants {time.time() - t0:.1f} s]", flush=True)
    return launches


# ---- phase_ranks: the multi-rank step on the one card ----------------------

RANK_B = 32               # rows a rank: the bench config's batch
RANK_STEPS = 3


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def params_digest(*modules) -> str:
    """sha256 of every state entry of ``modules``, bytes as on the card."""
    import hashlib
    h = hashlib.sha256()
    for m in modules:
        for k, v in sorted(m.state_dict().items()):
            h.update(k.encode() + v.detach().contiguous().view(torch.uint8)
                     .cpu().numpy().tobytes())
    return h.hexdigest()


def rank_config(scope: str, norm: str = "layerNorm"):
    from cpc_audio_tpu_torch.config import CPCConfig
    extra = {"negative_sampling_scope": "global",
             "negativeSamplingMode": "exact"} if scope == "global" else {}
    return CPCConfig(compute_dtype="bfloat16", normMode=norm, **extra)


def rank_batch(cfg) -> np.ndarray:
    """The global batch of RANKS * RANK_B windows every rank builds."""
    return synthetic_audio(cfg.sizeWindow, RANKS * RANK_B, SEED + 31)


class _PoolRecorder:
    """Stands in for criterion/infonce's ``scatter_add_rows`` (the exact
    sampler's backward) and ``sample_negatives``: records K8's pool rows
    and whether the negatives drew rows of another rank, and holds K8's
    first call against its plain version on the same inputs (which
    launches nothing)."""

    def __init__(self, infonce, sa, S: int):
        self.infonce, self.sa, self.S = infonce, sa, S
        self.rows, self.other_rank, self.err = [], [], None
        self.scatter, self.sample = infonce.scatter_add_rows, \
            infonce.sample_negatives

    def __enter__(self):
        def scatter(updates, keys, n_rows):
            out = self.scatter(updates, keys, n_rows)
            self.rows.append(n_rows)
            if self.err is None:
                want = self.sa.scatter_add_rows_ref(updates, keys, n_rows)
                atol, rtol, why = TOLERANCE[("scatter_add_rows",
                                             updates.dtype)]
                self.err = compare(f"K8 at the pool's {n_rows} rows, rank "
                                   f"0's exact-sampler backward", out, want,
                                   atol, rtol, why)
            return out

        def sample(encoded, W, N, batch_idx, seq_off, pool=None):
            idx, neg = self.sample(encoded, W, N, batch_idx, seq_off, pool)
            rows = idx // self.S
            from cpc_audio_tpu_torch.parallel import distributed
            r, B = distributed.rank(), encoded.shape[0]
            self.other_rank.append(bool(((rows < r * B) |
                                         (rows >= (r + 1) * B)).any()))
            return idx, neg
        self.infonce.scatter_add_rows = scatter
        self.infonce.sample_negatives = sample
        return self

    def __exit__(self, *exc):
        self.infonce.scatter_add_rows = self.scatter
        self.infonce.sample_negatives = self.sample


def _allreduce_profile(step, batch, key) -> dict:
    """torch.profiler over one step: the device time of the step's
    kernels and copies, and of the copies alone (gloo reduces on the
    host: every CUDA gradient goes to the host and back), and the host
    time of the gloo all_reduce calls."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(batch, key=key)
        torch.cuda.synchronize()
    out = {"allreduce_host_ms": 0.0, "memcpy_device_ms": 0.0,
           "device_ms": 0.0}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        out["device_ms"] += dev_us / 1e3
        if "all_reduce" in ev.key and "gloo" in ev.key:
            out["allreduce_host_ms"] += ev.cpu_time_total / 1e3
        if ev.key.startswith("Memcpy"):
            out["memcpy_device_ms"] += dev_us / 1e3
    return out


def _rank_run(r: int, dev, scope: str, norm: str = "layerNorm",
              steps: int = RANK_STEPS, profile: bool = False) -> dict:
    """One rank's steps of the config: launches, losses, per-step digests
    and host ms, and for batchNorm its local statistics and those after
    the step."""
    from cpc_audio_tpu_torch.criterion import build_criterion, infonce
    from cpc_audio_tpu_torch.models import build_model
    from cpc_audio_tpu_torch.ops import scatter_add as sa
    from cpc_audio_tpu_torch.parallel import distributed
    from cpc_audio_tpu_torch.parallel.train_step import (batch_stats,
                                                         create_train_state,
                                                         epoch_key,
                                                         make_train_step)
    cfg = rank_config(scope, norm)
    gen = torch.Generator().manual_seed(SEED)
    model = build_model(cfg, gen)
    crit = build_criterion(model.config, gen)
    state = create_train_state(model, crit, dev, cfg.learningRate)
    distributed.broadcast_([*model.state_dict().values(),
                            *crit.state_dict().values()])
    start = params_digest(model, crit)
    x = torch.from_numpy(distributed.rank_rows(rank_batch(cfg))).to(dev)
    key = epoch_key(SEED, 0, dev)
    step = make_train_step(state, dev)
    out = {"start": start, "digests": [], "ms": [], "losses": []}
    if norm == "batchNorm":
        local = copy.deepcopy(model)
        with torch.no_grad():
            local(x, train=True)
        out["local"] = [t.to("cpu", copy=True) for t in batch_stats(local)]
        del local
    S = cfg.sizeWindow // 160
    with _PoolRecorder(infonce, sa, S) as rec:
        fns = reset_counts()
        for i in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, m = step(x, key=key)
            torch.cuda.synchronize()
            out["ms"].append((time.perf_counter() - t0) * 1e3)
            out["losses"].append(m["losses"].float().cpu())
            out["digests"].append(params_digest(model, crit))
            if i == 0 and profile:
                out["params1"] = {k: v.detach().to("cpu", torch.float32,
                                                   copy=True)
                                  for mod in (model, crit)
                                  for k, v in mod.state_dict().items()}
        out["launches"] = {k: fn.launches for k, fn in fns.items()}
    out.update(pool_rows=rec.rows, other_rank=rec.other_rank,
               k8_err=rec.err)
    if norm == "batchNorm":
        out["stats"] = [t.to("cpu", copy=True) for t in batch_stats(model)]
    if profile:
        out["profile"] = _allreduce_profile(step, x, key)
        # the gradients' sum over ranks alone, as the step runs it (one
        # flat float32 buffer): host clock around a synchronised call
        grads = [p.grad for g in state.optimizer.param_groups
                 for p in g["params"]]
        out["grad_bytes"] = sum(t.numel() * t.element_size() for t in grads)
        out["allreduce_ms"] = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            distributed.sum_(grads)
            torch.cuda.synchronize()
            out["allreduce_ms"].append((time.perf_counter() - t0) * 1e3)
    return out


def _rank_child(r: int, n: int, store: str, out_dir: str) -> None:
    """A gloo rank on cuda:0 (spawned; the parent built the kernels)."""
    sys.path.insert(0, HERE)
    from cpc_audio_tpu_torch import _common
    from cpc_audio_tpu_torch.ops import _build
    from cpc_audio_tpu_torch.parallel import distributed
    _common.precision_policy()
    dev = torch.device("cuda", 0)
    if not os.path.isfile(_build.library_path()):
        fail(f"rank {r}: the kernel library is not built")
    distributed.init(r, n, dev, f"file://{store}", backend_name="gloo")
    try:
        results = {"device": _rank_run(r, dev, "device", profile=True),
                   "global": _rank_run(r, dev, "global"),
                   "batchNorm": _rank_run(r, dev, "global", "batchNorm",
                                          steps=1)}
        barrier = _build.grid_barrier(dev)
        results["barrier"] = (os.getpid(), barrier.data_ptr())
    finally:
        distributed.close()
    torch.save(results, os.path.join(out_dir, f"rank{r}.pt"))


def rank_replay(dev: torch.device) -> dict:
    """The first two-rank step, replayed in this process (no group): the
    two shards' gradients, each with its rank's streams, summed, then one
    Adam step from the same start; the parameters after it."""
    from cpc_audio_tpu_torch.criterion import build_criterion
    from cpc_audio_tpu_torch.models import build_model
    from cpc_audio_tpu_torch.parallel.train_step import (create_train_state,
                                                         epoch_key,
                                                         reduce_grads,
                                                         step_streams)
    cfg = rank_config("device")
    gen = torch.Generator().manual_seed(SEED)
    model = build_model(cfg, gen)
    crit = build_criterion(model.config, gen)
    state = create_train_state(model, crit, dev, cfg.learningRate)
    key = epoch_key(SEED, 0, dev)
    batch = rank_batch(cfg)
    model.train()
    crit.train()
    state.optimizer.zero_grad(set_to_none=True)
    for r in range(RANKS):
        x = torch.from_numpy(batch[r * RANK_B:(r + 1) * RANK_B]).to(dev)
        seed, keys, neg_seed = step_streams(key, state.step, r)
        c, z, _, _ = model(x, None, None, train=True, seed=seed)
        losses, _ = crit(c, z, None, train=True, round_keys=keys, seed=seed,
                         neg_seed=neg_seed)
        losses.sum().backward()
    reduce_grads(state.optimizer)
    state.optimizer.step()
    return {k: v.detach().float().cpu() for m in (model, crit)
            for k, v in m.state_dict().items()}


def ranks_nccl_cli(tmp: str) -> None:
    """(a) The train CLI with --distributed as torchrun would start one
    rank: NCCL at world size 1, on phase_cli's tree and flags (the
    default architecture, bf16, batch 8); its logged losses must equal
    phase_cli's first epoch bit for bit (a one-rank sum is the
    identity)."""
    db = os.path.join(tmp, "db")
    out = os.path.join(tmp, "ckpt_nccl")
    argv = ["--pathDB", db, "--file_extension", ".wav", "--pathCheckpoint",
            out, "--compute_dtype", "bfloat16", "--batchSizeGPU", "8",
            "--nEpoch", "1", "--n_process_loader", "2", "--ignore_cache",
            "--random_seed", str(SEED), "--arMode", "LSTM", "--distributed"]
    port = free_port()
    env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "cpc_audio_tpu_torch.train"]
                       + argv, cwd=HERE, env=env, capture_output=True,
                       text=True, timeout=600)
    if r.returncode != 0:
        fail(f"the --distributed CLI (NCCL, world 1) exited "
             f"{r.returncode}: {r.stdout[-1500:]} {r.stderr[-1500:]}")
    with open(os.path.join(out, "checkpoint_logs.json")) as f:
        got = json.load(f)
    with open(os.path.join(tmp, "ckpt_LSTM_8_0", "checkpoint_logs.json")) as f:
        want = json.load(f)
    keys = [k for k in got if k.startswith("loc")]
    same = {k: got[k][0] == want[k][0] for k in keys}
    print(f"(a) --distributed, NCCL {torch.cuda.nccl.version()}, world 1 "
          f"(MASTER_PORT {port}): rc 0 in {time.perf_counter() - t0:.1f} s; "
          f"{[ln for ln in r.stdout.splitlines() if 'devices' in ln]}; "
          f"epoch 0 against phase_cli's, bit for bit: {same}; train losses "
          f"{got['locLoss_train'][0]}", flush=True)
    if not keys or not all(same.values()):
        fail(f"the NCCL world-1 CLI's logs differ from phase_cli's: "
             f"{ {k: (got[k][0], want[k][0]) for k in keys} }")


def phase_ranks(tmp: str, dev: torch.device) -> dict:
    """(a) NCCL at world 1 through the CLI, (b) RANKS gloo ranks on the
    card, (c) --nGPU 2 clamped to the one card; returns the JSON line's
    launches of K8 on the pool (rank 0's, under the global scope)."""
    t0 = time.time()
    ranks_nccl_cli(tmp)
    print(f"[phase ranks (a) {time.time() - t0:.1f} s]", flush=True)
    t1 = time.time()
    pool_launches = ranks_two_gloo(tmp, dev)
    print(f"[phase ranks (b) {time.time() - t1:.1f} s]", flush=True)
    t1 = time.time()
    ranks_clamped(tmp)
    print(f"[phase ranks (c) {time.time() - t1:.1f} s]", flush=True)
    print(f"[phase ranks {time.time() - t0:.1f} s]", flush=True)
    return {"scatter_add_rows_pool": pool_launches}


def ranks_clamped(tmp: str) -> None:
    """(c) --nGPU 2 on a one-card host runs one rank, as JAX clamps it."""
    from cpc_audio_tpu_torch import train
    argv = default_argv(os.path.join(tmp, "db"),
                        os.path.join(tmp, "ckpt_ngpu2"), "bfloat16",
                        "--nGPU", "2")
    lines = _run_cli(train, argv, "--nGPU 2 on one card",
                     PATH_KERNELS["LSTM"])
    said = [ln for ln in lines if ln.startswith("Let's use")]
    print(f"(c) --nGPU 2 on {torch.cuda.device_count()} card: {said}",
          flush=True)
    if not said or not said[0].startswith("Let's use 1 devices"):
        fail(f"--nGPU 2 on one card did not run one rank: {said}")


def ranks_two_gloo(tmp: str, dev: torch.device) -> int:
    """(b) RANKS gloo ranks, spawned, both on cuda:0, at the bench config
    (hiddenEncoder = hiddenGar = 256, 12 heads, 128 negatives, sizeWindow
    20480, bf16, dropout 0.1 in the heads) with RANK_B rows a rank:
    RANK_STEPS steps of make_train_step with the device scope, then with
    --negative_sampling_scope global (exact sampler), then one
    --normMode batchNorm step.  Returns rank 0's K8 launches on the
    pool."""
    import torch.multiprocessing as mp
    out_dir = os.path.join(tmp, "ranks")
    os.makedirs(out_dir, exist_ok=True)
    torch.cuda.empty_cache()        # the card's memory for the ranks
    t0 = time.perf_counter()
    mp.start_processes(_rank_child, args=(RANKS, os.path.join(out_dir,
                                                              "store"),
                                          out_dir),
                       nprocs=RANKS, join=True, start_method="spawn")
    print(f"(b) {RANKS} gloo ranks on cuda:0: done in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    res = [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                      weights_only=False) for r in range(RANKS)]
    for part in ("device", "global", "batchNorm"):
        a, b = res[0][part], res[1][part]
        if a["start"] != b["start"]:
            fail(f"(b) {part}: the ranks started from other weights")
        for i, (da, db) in enumerate(zip(a["digests"], b["digests"])):
            if da != db:
                fail(f"(b) {part}: the ranks' parameters differ after step "
                     f"{i + 1}")
        for r, rr in enumerate(res):
            got = rr[part]
            losses = torch.stack(got["losses"])
            if not torch.isfinite(losses).all():
                fail(f"(b) {part} rank {r}: losses not finite")
            names = ("lstm_fwd", "lstm_bwd", "relpos_attention_fwd",
                     "relpos_attention_bwd", "layer_tail_fwd",
                     "layer_tail_bwd", "scatter_add_rows")
            print(f"(b) {part} rank {r}: launches "
                  f"{ {k: got['launches'][k] for k in names} }, step ms "
                  f"(host clock) {[round(t, 2) for t in got['ms']]}, "
                  f"loss sums "
                  f"{[round(float(v.sum()), 4) for v in got['losses']]}",
                  flush=True)
            want = PATH_KERNELS["LSTM"] + (("scatter_add_rows",)
                                            if part != "device" else ())
            for k in want:
                if got["launches"][k] <= 0:
                    fail(f"(b) {part} rank {r} did not launch {k}")
        print(f"(b) {part}: parameters bit-identical across ranks after "
              f"each of {len(a['digests'])} steps", flush=True)
    # the global pool: K8 on RANKS * B * S rows, rank 0 draws rank 1's rows
    g0 = res[0]["global"]
    rows = RANKS * RANK_B * (rank_config("global").sizeWindow // 160)
    if not g0["pool_rows"] or set(g0["pool_rows"]) != {rows}:
        fail(f"(b) global: K8 ran on {g0['pool_rows']} pool rows, not "
             f"{rows}")
    if not all(g0["other_rank"]):
        fail("(b) global: rank 0's negatives drew no row of rank 1")
    print(f"(b) global: K8 on {rows} pool rows, {len(g0['pool_rows'])} "
          f"calls, against its plain version max |err| {g0['k8_err']:.3e}; "
          f"rank 0 drew rows of rank 1 in every step", flush=True)
    # batchNorm: the running statistics are the mean of the local updates
    bn = [rr["batchNorm"] for rr in res]
    worst = 0.0
    for i, stat in enumerate(bn[0]["stats"]):
        mean_local = (bn[0]["local"][i] + bn[1]["local"][i]) / 2
        worst = max(worst, (stat - mean_local).abs().max().item())
        if not torch.equal(stat, bn[1]["stats"][i]):
            fail("(b) batchNorm: the ranks' running statistics differ")
    differs = any(not torch.allclose(s0, l0) for s0, l0 in
                  zip(bn[0]["stats"], bn[0]["local"]))
    print(f"(b) batchNorm: running statistics = the mean of the ranks' "
          f"local updates within {worst:.3e}; not rank 0's own: {differs}",
          flush=True)
    if worst > 1e-5 or not differs:
        fail(f"(b) batchNorm: running statistics are not the rank mean "
             f"({worst:.3e}, differs {differs})")
    # the replay: one process, the two shards' gradients summed
    first = res[0]["device"]
    replay = rank_replay(dev)
    torch.cuda.empty_cache()
    diff = max((replay[k] - v).abs().max().item()
               for k, v in first["params1"].items())
    same = all(torch.equal(replay[k], v) for k, v in first["params1"].items())
    print(f"(b) replay in one process (both shards' gradients, each with "
          f"its rank's streams, summed; one Adam step): parameters after "
          f"step 1 within {diff:.3e} of rank 0's (bit-equal: {same}; "
          f"tolerance 5e-6, tests/test_torch_distributed.py)", flush=True)
    if diff > 5e-6:
        fail(f"(b) the two-rank step is not the replay's: {diff:.3e}")
    print(f"(b) per-rank step ms (host clock, both ranks on one card): "
          f"rank 0 {[round(t, 2) for t in first['ms']]}, rank 1 "
          f"{[round(t, 2) for t in res[1]['device']['ms']]}; the gradients' "
          f"gloo all_reduce alone ({first['grad_bytes'] / 1e6:.1f} MB "
          f"float32), host clock: rank 0 "
          f"{[round(t, 2) for t in first['allreduce_ms']]} ms, rank 1 "
          f"{[round(t, 2) for t in res[1]['device']['allreduce_ms']]} ms; "
          f"one step under torch.profiler (rank 0): {first['profile']}",
          flush=True)
    print(f"(b) each rank's grid-barrier word (pid, address): "
          f"{[rr['barrier'] for rr in res]}", flush=True)
    return g0["launches"]["scatter_add_rows"]


# ---- the long-window and wide shapes ----------------------------------------

def _k2_shape(q, k, v, krel, *args, **kwargs):
    return tuple(krel.shape[1:])           # (dk, S)


def _k5_shape(q, *args, **kwargs):
    return tuple(q.shape[1:])              # (S, dk)


def long_wide_train(dev: torch.device, path: str) -> dict:
    """One path of LONG_WIDE_PATHS through phase_train at B 4 (2 warm-up
    and 4 timed steps, then 3 profiled), every K2 and K5 call recorded by
    shape: each must run at the path's (S, dk), the heads' S = sizeWindow
    // 160 - 12, the AR's S = sizeWindow // 160, dk = hiddenEncoder / 8,
    in every one of the launches its wrapper counted over the 6 steps
    (and in the profiled steps' too)."""
    from cpc_audio_tpu_torch.ops import causal_attention, head_attention
    cfg = PATH_CONFIG[path]
    W, D = cfg.get("sizeWindow", 20480), cfg.get("hiddenEncoder", 256)
    with recorded(head_attention, {"relpos_attention_fwd": _k2_shape,
                                   "relpos_attention_bwd": _k2_shape}) as k2, \
            recorded(causal_attention, {"causal_attention_fwd": _k5_shape,
                                        "causal_attention_bwd": _k5_shape}
                     ) as k5:
        counts = phase_train(dev, path, B=4, timed=4)
    want = {name: (D // 8, W // 160 - 12) for name in k2}
    if path.startswith("transformer"):
        want.update({name: (W // 160, D // 8) for name in k5})
    got = {**k2, **k5}
    for name, shape in want.items():
        if set(got[name]) != {shape} or len(got[name]) < counts[name]:
            fail(f"{path}: {name} ran at {sorted(set(got[name]))} "
                 f"({len(got[name])} calls), not at {shape} in each of its "
                 f"{counts[name]} counted launches")
    print(f"{path}: " + ", ".join(
        f"{name} at {'(dk, S)' if name in k2 else '(S, dk)'} {shape} in "
        f"all its {len(got[name])} calls" for name, shape in want.items()),
        flush=True)
    return counts


# K2's cases of phase_long_and_wide: (S, dk, K, B, heads), fewer heads
# than the train step's K 12 x B 4 x 8, whose (S, S) plain tiles at S 4084
# would take 25.6 GB each: S 2048 and the heads' 4084 on the tensor-core
# body, and S 3700 at dk 264 on its DKP-512 tiles; the tensor-core body at
# the --hiddenEncoder 4096 path's shape (S 116, dk 512, K 12, B 4); the
# cluster body past dk 512 at the --hiddenEncoder 4160 path's shape (S 116,
# dk 520: two CTAs a tile, the second's 8 columns on one warp), at dk 1024
# (two whole slabs) and at S 3700 / dk 520
LONG_WIDE_K2 = ((2048, 32, 2, 1, 8), (4084, 32, 1, 1, 8),
                (3700, 264, 1, 1, 2), (116, 512, 12, 4, 8),
                (116, 520, 12, 4, 8), (116, 1024, 4, 4, 8),
                (3700, 520, 1, 1, 2))
# K5's: the AR at --sizeWindow 655360 (N = 4 x 8 rows of S 4096, dk 32)
# and at --hiddenEncoder 4096 (S 128, dk 512); K1's and K4's at
# --hiddenGar 8192 (B 4, T 128: the grid bodies, W_hh streamed)
LONG_WIDE_K5 = ((32, 4096, 32), (32, 128, 512))
# the models alone at --hiddenGar 8192 step at CPCConfig's --learningRate
LONG_WIDE_LR = 2e-4
H8192_SHAPES = (("lstm", 4, 128, 8192), ("gru", 4, 128, 8192))


def long_wide_cases(dev: torch.device, dtype: torch.dtype) -> list:
    g = torch.Generator(device=dev).manual_seed(SEED + 41)

    def rand(*shape, scale=1.0, dt=dtype):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dt)
    seed = torch.tensor([SEED], dtype=torch.int64, device=dev)
    cases = []
    for S, dk, K, B, h in LONG_WIDE_K2:
        for case in relpos_cases(rand, seed, B, S, dk, K, h):
            case.label += f" (K {K}, B {B}, {h} heads)"
            cases.append(case)
    for N, S, dk in LONG_WIDE_K5:
        cases += causal_cases(rand, seed, N, S, dk, f"S {S} / dk {dk}")
    return cases + recurrent_cases(rand, dev, H8192_SHAPES)


def check_case(case: Case, dtype: torch.dtype) -> dict:
    """One case against its plain version under TOLERANCE, then the
    kernel's and the plain version's device time a call (the median of
    two runs), the kernel's bound; a K2 / K5 case rerun bit-identically,
    and a K1 / K4 case's grid body."""
    name = case.name
    got, want = case.kernel(), case.plain()
    torch.cuda.synchronize()
    b = bound(case, got, dtype)
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    if name.endswith("_bwd"):
        rel, why = TOLERANCE[(name, dtype)]
        err = max(compare_norm(f"{case.label} grad {i}", gi, wi, rel, why)
                  for i, (gi, wi) in enumerate(zip(got, want)))
    else:
        atol, rtol, why = TOLERANCE[(name, dtype)]
        err = max(compare(f"{case.label} out {i}", gi, wi, atol, rtol, why)
                  for i, (gi, wi) in enumerate(zip(got, want)))
    del want
    if name.startswith(("relpos", "causal")):
        again = _tensors(case.kernel())
        if not all(torch.equal(a, g) for a, g in zip(again, got)):
            fail(f"{case.label}: a rerun differs from the first run")
        print(f"  {case.label}: a rerun bit-identical", flush=True)
        del again
    del got
    ms = median_ms(case.kernel, reps=2)
    plain_ms = median_ms(case.plain, reps=2)
    body = recurrent_body(case, dtype)
    if body is not None:
        recurrent_rerun(case, body)
    split = (f" as bf16 split products; on the float32 cores "
             f"{b['fp32_ms']:.4f} ms" if b["split"] else "")
    print(f"  {case.label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
          f"(device time a call); bound {b['bound_ms']:.4f} ms by "
          f"{b['bound_by']} ({b['bytes'] / 1e6:.2f} MB, "
          f"{b['flops'] / 1e9:.3f} GFLOP{split}), {b['bound_ms'] / ms:.1%} "
          f"of it", flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
            "library_ms": None}


# the JSON line's entries of phase_long_and_wide: (kernel, the case's
# shape tag) of each, in bf16 (the train paths' dtype)
LONG_WIDE_ENTRIES = {
    "relpos_attention_fwd_s4084": ("relpos_attention_fwd", "S 4084 / dk 32"),
    "relpos_attention_bwd_s4084": ("relpos_attention_bwd", "S 4084 / dk 32"),
    "relpos_attention_fwd_dk512": ("relpos_attention_fwd", "S 116 / dk 512"),
    "relpos_attention_bwd_dk512": ("relpos_attention_bwd", "S 116 / dk 512"),
    "relpos_attention_fwd_s3700": ("relpos_attention_fwd", "S 3700 / dk 264"),
    "relpos_attention_bwd_s3700": ("relpos_attention_bwd", "S 3700 / dk 264"),
    "relpos_attention_fwd_cluster": ("relpos_attention_fwd",
                                     "S 116 / dk 520"),
    "relpos_attention_bwd_cluster": ("relpos_attention_bwd",
                                     "S 116 / dk 520"),
    "causal_attention_fwd_s4096": ("causal_attention_fwd", "S 4096 / dk 32"),
    "causal_attention_bwd_s4096": ("causal_attention_bwd", "S 4096 / dk 32"),
    "causal_attention_fwd_dk512": ("causal_attention_fwd", "S 128 / dk 512"),
    "causal_attention_bwd_dk512": ("causal_attention_bwd", "S 128 / dk 512"),
    "lstm_fwd_h8192": ("lstm_fwd", "B 4 / T 128 / H 8192"),
    "lstm_bwd_h8192": ("lstm_bwd", "B 4 / T 128 / H 8192"),
    "gru_fwd_h8192": ("gru_fwd", "B 4 / T 128 / H 8192"),
    "gru_bwd_h8192": ("gru_bwd", "B 4 / T 128 / H 8192"),
}


def long_wide_kernels(dev: torch.device) -> dict:
    """Phase (d): each widened kernel against its plain version, forward
    and backward, both dtypes, at rate 0.1 where it drops (LONG_WIDE_K2,
    LONG_WIDE_K5, H8192_SHAPES); K2 also at the train step's K 12 x B 4
    at S 4084, the kernel alone; then K5 beside SDPA (its dense bias as a
    float mask, rate 0) and K1 / K4 beside cuDNN's layers, in turns.
    Returns LONG_WIDE_ENTRIES' numbers."""
    from cpc_audio_tpu_torch.ops import head_attention as ha
    results, by_shape = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        print(f"long and wide kernels vs plain versions, "
              f"{str(dtype)[6:]}:", flush=True)
        for case in long_wide_cases(dev, dtype):
            r = check_case(case, dtype)
            if dtype == torch.bfloat16:
                by_shape[(case.name, case.shape)] = r
        torch.cuda.empty_cache()
        # K2 at the train step's whole K 12 x B 4 x 8 heads, S 4084
        g = torch.Generator(device=dev).manual_seed(SEED + 43)
        K, B, S, h, dk = 12, 4, 4084, 8, 32

        def rand(*shape, scale=1.0):
            return (torch.randn(shape, generator=g, device=dev)
                    * scale).to(dtype)
        args = [rand(K, B * S, h * dk) for _ in range(3)]
        args.append(rand(K, dk, S, scale=0.5))
        dout = rand(K, B * S, h * dk, scale=0.1)
        seed = torch.tensor([SEED], dtype=torch.int64, device=dev)
        fwd = median_ms(lambda: ha.relpos_attention_fwd(*args, B, h, 0.1,
                                                        seed), reps=2)
        bwd = median_ms(lambda: ha.relpos_attention_bwd(*args, dout, B, h,
                                                        0.1, seed), reps=2)
        print(f"  K2 at the --sizeWindow 655360 train step's K {K} x B {B} "
              f"x {h} heads, S {S} / dk {dk}, rate 0.1, {str(dtype)[6:]}: "
              f"forward {fwd:.4f} ms, backward {bwd:.4f} ms (device time a "
              f"call, the kernel alone)", flush=True)
        del args, dout
        torch.cuda.empty_cache()
    sdpa = {}
    for N, S, dk in LONG_WIDE_K5:
        sdpa.update({(name, dt, S): ms for (name, dt), ms in
                     long_causal_yardsticks(dev, N // 8, S, dk).items()})
    cudnn = rows_yardsticks(dev, [(k, B, H) for k, B, _, H in H8192_SHAPES],
                            warmup=1, reps=2)
    for entry, (name, shape) in LONG_WIDE_ENTRIES.items():
        results[entry] = dict(by_shape[(name, shape)])
        if name.startswith("causal"):
            S = int(shape.split()[1])
            results[entry]["library_ms"] = sdpa[(name, torch.bfloat16, S)]
        elif name.startswith(("lstm", "gru")):
            results[entry]["library_ms"] = cudnn[(name, 4, 8192,
                                                  torch.bfloat16)]
    return results


def phase_long_and_wide(dev: torch.device) -> tuple:
    """The shapes the JAX package trains past the port's first limits: (d)
    the widened kernels against their plain versions and their
    yardsticks; (a) the default model (LSTM AR, transformer heads) at
    --sizeWindow 655360 (K2 at S 4084) and (b) the transformer AR there
    (K5 at S 4096) and at --hiddenEncoder 4096 --hiddenGar 4096 (K5 and
    K2 at dk 512 on their DKP-512 tensor-core bodies), B 4, both dtypes,
    and the default model at --hiddenEncoder 4160 (K2's cluster body at
    dk 520), bf16, each loss finite and falling; (c) LSTM and GRU models alone at --hiddenGar 8192 (the
    grid bodies at J 64 units a CTA on 132 SMs).  Returns (the JSON
    line's entries, their launches on the paths)."""
    t0 = time.time()
    timings = long_wide_kernels(dev)
    print(f"[phase long/wide kernels {time.time() - t0:.1f} s]", flush=True)
    counts = {}
    for path in LONG_WIDE_PATHS:
        t0 = time.time()
        counts[path] = long_wide_train(dev, path)
        torch.cuda.empty_cache()
        print(f"[phase train {path} {time.time() - t0:.1f} s]", flush=True)
    launches = {}
    # the S 3700 / dk 264 entries run K2's DKP-512 tensor-core kernels,
    # which the --hiddenEncoder 4096 path launches (no path trains S 3700
    # at dk 257-512)
    for entry, (name, shape) in LONG_WIDE_ENTRIES.items():
        path = (L655 if entry.endswith("s4084") else
                T655 if entry.endswith("s4096") else
                T4096 if entry.endswith(("dk512", "s3700")) else
                L4160 if entry.endswith("_cluster") else None)
        if path is not None:
            launches[entry] = counts[path][name]
    for mode in ("LSTM", "GRU"):
        t0 = time.time()
        # the model's steps run the grid bodies once a step each way
        # (check_body): the backward's launches are the forward's.  At
        # the trainer's own rate (--learningRate 2e-4): Adam's step moves
        # each unit's pre-activation by up to lr times the sum of |h| over
        # 8192 units, and at 1e-3 the loss overshoots, with the kernels
        # and with their plain versions alike (port_perf/wide_model_lr.py)
        n = phase_model_alone(dev, mode, 8192, B=4, steps=4, body="grid",
                              fwd_body="grid", lr=LONG_WIDE_LR)
        for d in ("fwd", "bwd"):
            launches[f"{mode.lower()}_{d}_h8192"] = n
        torch.cuda.empty_cache()
        print(f"[phase {mode} --hiddenGar 8192 {time.time() - t0:.1f} s]",
              flush=True)
    return timings, launches


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
    # the package's policy, which its entry points also set: the kernel
    # phase's float32 yardsticks run under it too
    from cpc_audio_tpu_torch import _common
    _common.precision_policy()
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
    for path in PATH_KERNELS:
        if path not in (EXACT, LONG, W768, F32, G512, T32, T2048, T163840):
            phase_eval(dev, path)
    phase_eval_auto_exact(dev)
    print(f"[phase eval {time.time() - t0:.1f} s]", flush=True)
    # each path reports the launches of its own kernels: the AR's, and K2,
    # K3 from the default path, K6, K7 from the fused-layer path, K8 from
    # the exact sampler's
    launches = {}
    for path, own in (("LSTM", PATH_KERNELS["LSTM"]),
                      ("GRU", ("gru_fwd", "gru_bwd")),
                      ("transformer", ("causal_attention_fwd",
                                       "causal_attention_bwd")),
                      (FUSED, ("attention_block_fwd", "attention_block_bwd",
                               "conv_ln_fwd", "conv_ln_bwd")),
                      (EXACT, ("scatter_add_rows",)),
                      (WIDE, ()), (LONG, ()), (W768, ()), (F32, ()),
                      (F512, ()), (F768, ()), (W200, ()), (W1056, ()),
                      (G512, ()), (T32, ()), (T2048, ()), (T163840, ())):
        t0 = time.time()
        # the long-window path at a small batch, as users fit it on a card;
        # the 2048-wide and 163840-sample transformers at B 4, 4 timed
        counts = phase_train(dev, path,
                             B=8 if path == LONG else
                             4 if path in SMALL_PATHS else 32,
                             timed=4 if path in SMALL_PATHS else 10)
        launches.update({name: counts[name] for name in own})
        # the grid bodies' launches on the paths that run them (K1 at
        # --hiddenGar 1056, K4 at 512): check_body held them to the steps
        if path in (W1056, G512):
            fns = counters()
            for name in PATH_KERNELS[path][:2]:
                launches[f"{name}_grid"] = \
                    fns[name].body_launches["grid"]
        # K1's rows forward at --hiddenGar 200 (check_body held it)
        if path == W200:
            launches["lstm_fwd_rows"] = \
                counters()["lstm_fwd"].body_launches["rows"]
        # a float32 path's step on two windows is that of the bf16 path of
        # its widths: the default LSTM's, the long window's (K1's float32
        # cluster bodies at H 512) and the 768-wide's (at H 768); the
        # float32 transformer's is K5's float32 body in its own step (the
        # transformer path's check runs the same config)
        if path not in FLOAT32_PATHS or path == T32:
            check_train_against_cpu(dev, path)
        print(f"[phase train {path} {time.time() - t0:.1f} s]", flush=True)
    t0 = time.time()
    phase_model_alone(dev)
    print(f"[phase GRU --hiddenGar 100 {time.time() - t0:.1f} s]",
          flush=True)
    # K4's rows forward and backward at H 224
    t0 = time.time()
    launches["gru_fwd_rows"] = phase_model_alone(dev, "GRU", 200,
                                                 body="rows",
                                                 fwd_body="rows")
    print(f"[phase GRU --hiddenGar 200 {time.time() - t0:.1f} s]",
          flush=True)
    for mode in ("LSTM", "GRU"):
        t0 = time.time()
        phase_model_alone(dev, mode, 4096, B=4, steps=4, body="grid",
                          fwd_body="grid")
        print(f"[phase {mode} --hiddenGar 4096 {time.time() - t0:.1f} s]",
              flush=True)
    t0 = time.time()
    wide, wide_launches = phase_long_and_wide(dev)
    timings.update(wide)
    launches.update(wide_launches)
    print(f"[phase long and wide {time.time() - t0:.1f} s]", flush=True)
    t0 = time.time()
    phase_stop_grad(dev)
    print(f"[phase stop-grad {time.time() - t0:.1f} s]", flush=True)
    t0 = time.time()
    ab_train(dev, FUSED)
    ab_train(dev, EXACT)
    print(f"[phase A/B {time.time() - t0:.1f} s]", flush=True)
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        phase_cli(tmp, dev)
        print(f"[phase train CLI {time.time() - t0:.1f} s]", flush=True)
        launches["lstm_fwd_features"], runs = phase_interchange(tmp, dev)
        launches.update(phase_eval_clis(tmp, runs, dev))
        launches.update(phase_variants(tmp, dev))
        launches.update(phase_ranks(tmp, dev))
    kernels = [{"name": name, "route": "cuda", "source": SOURCES[name][0],
                "replaces": SOURCES[name][1], "launches": launches[name],
                **timings[name]} for name in SOURCES]
    for line in SUMMARY.values():
        print(line)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
