"""Build the port's CUDA kernels on first use and bind them with ctypes.

Each ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all
started together, and the objects are linked into one shared library with
a plain C interface (no PyTorch headers, so the build takes seconds).
The library's name carries a hash of the sources and flags, so an edited
source is rebuilt and an unchanged one is reused.  It lands in
``build/cuda_kernels/`` beside the package (``build/`` is git-ignored),
next to the compiler's ``-Xptxas -v`` report.

Each C entry point that launches returns ``cudaGetLastError()``;
:func:`check` raises on anything but 0.  A failed build raises: there is
no fallback.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "cuda_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
_DROP = [_P, _U, _F]          # dropout: seed pointer, threshold, keep scale
# C entry points: argument types and return type.
_SIGNATURES = {
    # x_proj, w_hh, h0, c0, ys, hT, cT, gates, cs, scratch, barrier, B, T,
    # H, dtype, stream
    "cpc_lstm_fwd": ([_P] * 11 + [_I] * 4 + [_P], _I),
    # B, H, dtype
    "cpc_lstm_fwd_scratch": ([_I] * 3, ctypes.c_size_t),
    # gates, cs, c0, dys, w_hh, dhT, dcT, dgates, dh0, dc0, scratch,
    # barrier, B, T, H, dtype, stream
    "cpc_lstm_bwd": ([_P] * 12 + [_I] * 4 + [_P], _I),
    # B, H, dtype
    "cpc_lstm_bwd_scratch": ([_I] * 3, ctypes.c_size_t),
    # H, dtype
    "cpc_lstm_fwd_body": ([_I, _I], _I),
    "cpc_lstm_fwd_smem": ([_I, _I], ctypes.c_size_t),
    "cpc_lstm_bwd_body": ([_I, _I], _I),
    "cpc_lstm_bwd_smem": ([_I, _I], ctypes.c_size_t),
    # H, G, dtype, backward
    "cpc_rnn_grid_smem": ([_I] * 4, ctypes.c_size_t),
    # S, dk, dtype
    "cpc_relpos_attention_fwd_body": ([_I] * 3, _I),
    "cpc_relpos_attention_bwd_body": ([_I] * 3, _I),
    # q, k, v, krel, out, scratch, K, n_batch, S, nheads, dk, dropout,
    # dtype, stream
    "cpc_relpos_attention_fwd_tc": ([_P] * 6 + [_I] * 5 + _DROP + [_I, _P],
                                    _I),
    # K, n_batch, S, nheads, dk, dtype
    "cpc_relpos_attention_fwd_tc_scratch": ([_I] * 6, ctypes.c_size_t),
    # q, k, v, krel, dout, dq, dk, dv, dkrel, scratch, K, n_batch, S,
    # nheads, dk, dropout, dtype, stream
    "cpc_relpos_attention_bwd_tc": ([_P] * 10 + [_I] * 5 + _DROP + [_I, _P],
                                    _I),
    # K, n_batch, S, nheads, dk, dtype
    "cpc_relpos_attention_bwd_tc_scratch": ([_I] * 6, ctypes.c_size_t),
    # x, ln1w, ln1b, w1, b1, w2, b2, ln2w, ln2b, out, scratch, K, M, D, F,
    # eps, dropout, dtype, stream
    "cpc_layer_tail_fwd": ([_P] * 11 + [_I] * 4 + [_F] + _DROP + [_I, _P],
                           _I),
    # K, M, D, F, dtype
    "cpc_layer_tail_fwd_scratch": ([_I] * 5, ctypes.c_size_t),
    # x, ln1w, ln1b, w1, b1, w2, b2, ln2w, ln2b, dout, dx, vec_part,
    # vec_out, dw1, db1, dw2, scratch, K, M, D, F, eps, dropout, dtype,
    # stream
    "cpc_layer_tail_bwd": ([_P] * 17 + [_I] * 4 + [_F] + _DROP + [_I, _P],
                           _I),
    # M, D, dtype
    "cpc_layer_tail_bwd_tiles": ([_I, _I, _I], _I),
    # D, F, dtype
    "cpc_layer_tail_bwd_smem": ([_I, _I, _I], ctypes.c_size_t),
    # K, M, D, F, dtype
    "cpc_layer_tail_bwd_scratch": ([_I] * 5, ctypes.c_size_t),
    # x_proj, w_hh, b_hh, h0, ys, hT, gates, ghn, scratch, barrier, B, T,
    # H, dtype, stream
    "cpc_gru_fwd": ([_P] * 10 + [_I] * 4 + [_P], _I),
    # gates, ghn, h0, ys, dys, w_hh, dhT, dx, dghn, dh0, scratch, barrier,
    # B, T, H, dtype, stream
    "cpc_gru_bwd": ([_P] * 12 + [_I] * 4 + [_P], _I),
    # B, H, dtype
    "cpc_gru_fwd_scratch": ([_I] * 3, ctypes.c_size_t),
    "cpc_gru_bwd_scratch": ([_I] * 3, ctypes.c_size_t),
    # H, dtype
    "cpc_gru_fwd_body": ([_I, _I], _I),
    "cpc_gru_fwd_smem": ([_I, _I], ctypes.c_size_t),
    "cpc_gru_bwd_body": ([_I, _I], _I),
    # q, k, v, bias, out, scratch, N, S, dk, layer, dropout, dtype, stream
    "cpc_causal_attention_fwd": ([_P] * 6 + [_I] * 4 + _DROP + [_I, _P], _I),
    # N, S, dk, dtype
    "cpc_causal_attention_fwd_scratch": ([_I] * 4, ctypes.c_size_t),
    # q, k, v, bias, dout, dq, dk, dv, dbias, scratch, N, S, dk, layer,
    # dropout, dtype, stream
    "cpc_causal_attention_bwd": ([_P] * 10 + [_I] * 4 + _DROP + [_I, _P],
                                 _I),
    # N, S, dk, dtype
    "cpc_causal_attention_bwd_scratch": ([_I] * 4, ctypes.c_size_t),
    # c, wq, wk, wv, wo, krel, x, qkv, y, scratch, K, n_batch, S, nheads,
    # dk, dropout, dtype, stream
    "cpc_attention_block_fwd": ([_P] * 10 + [_I] * 5 + _DROP + [_I, _P],
                                _I),
    # K, n_batch, S, nheads, dk, dtype
    "cpc_attention_block_fwd_scratch": ([_I] * 6, ctypes.c_size_t),
    # c, wq, wk, wv, wo, krel, dout, qkv, y, dkrel, dw, dcp, scratch, K,
    # n_batch, S, nheads, dk, dropout, dtype, stream
    "cpc_attention_block_bwd": ([_P] * 13 + [_I] * 5 + _DROP + [_I, _P],
                                _I),
    # K, n_batch, S, nheads, dk, dtype
    "cpc_attention_block_bwd_scratch": ([_I] * 6, ctypes.c_size_t),
    # x, w, bias, nw, nb, out, yn, inv, scratch, B, T, C, stride, pad,
    # eps, dtype, stream
    "cpc_conv_ln_fwd": ([_P] * 9 + [_I] * 5 + [_F, _I, _P], _I),
    # B, T, C, stride, pad, dtype
    "cpc_conv_ln_fwd_scratch": ([_I] * 6, ctypes.c_size_t),
    # x, w, nw, nb, dy, yn, inv, dx, vout, dw, scratch, B, T, C, stride,
    # pad, dtype, stream
    "cpc_conv_ln_bwd": ([_P] * 11 + [_I] * 6 + [_P], _I),
    # B, T, C, stride, pad, dtype
    "cpc_conv_ln_bwd_scratch": ([_I] * 6, ctypes.c_size_t),
    # updates, order, offsets, out, R, C, dtype, stream
    "cpc_scatter_add": ([_P] * 4 + [_I] * 3 + [_P], _I),
}

_LOCK = threading.Lock()
_LIB = None


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources():
    srcs = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    headers = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return srcs, headers


def library_path() -> str:
    """Where the library for the current sources and flags lives."""
    srcs, headers = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in srcs + headers:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libcpc_kernels_{h.hexdigest()[:16]}.so")


def build_log_path() -> str:
    return library_path()[:-3] + ".log"


def _build(path: str) -> None:
    srcs, _ = _sources()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}"
    objs = [f"{tmp}.{os.path.basename(src)}.o" for src in srcs]
    nvcc = _nvcc()
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
            for src, obj in zip(srcs, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [p.communicate()[0] for p in procs]
    link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", f"{tmp}.so", *objs]
    failed = [(cmd, out) for cmd, out, p in zip(cmds, outs, procs)
              if p.returncode != 0]
    if not failed:
        r = subprocess.run(link, capture_output=True, text=True)
        outs.append(r.stdout + r.stderr)
        if r.returncode != 0:
            failed.append((link, r.stdout + r.stderr))
    with open(build_log_path(), "w") as f:
        for cmd, out in zip(cmds + [link], outs):
            f.write(" ".join(cmd) + "\n" + out)
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        cmd, out = failed[0]
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{out}")
    os.replace(f"{tmp}.so", path)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            path = library_path()
            if not os.path.isfile(path):
                _build(path)
            lib = ctypes.CDLL(path)
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            lib.cpc_error_string.argtypes = [ctypes.c_int]
            lib.cpc_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def check(status: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if status != 0:
        msg = library().cpc_error_string(status).decode()
        raise RuntimeError(f"{name} failed: CUDA error {status} ({msg})")


# --- helpers shared by the kernel wrappers ---------------------------------

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 232448           # bytes of shared memory a block may use


def require_smem(name: str, smem: int, what: str) -> None:
    """Refuse a shape whose block needs more shared memory than the card
    gives one block (227 KB on an H100)."""
    require(smem <= SMEM_LIMIT, name,
            f"{what} needs {smem} bytes of shared memory (at most "
            f"{SMEM_LIMIT})")


def runs_kernel(name: str, *tensors: torch.Tensor) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors
    (run the plain version); raises for anything else."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs on several devices {devices}")
    device = devices.pop()
    if device.type == "cpu":
        return False
    if device.type == "cuda":
        return True
    raise ValueError(f"{name}: no kernel for device {device}")


def require(cond: bool, name: str, what: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {what}")


def check_inputs(name: str, dtype: torch.dtype, **tensors) -> None:
    """Kernel inputs: contiguous, of one supported dtype."""
    require(dtype in DTYPE_CODES, name,
            f"dtype {dtype} not supported (float32 or bfloat16)")
    for arg, t in tensors.items():
        require(t.dtype == dtype, name, f"{arg} is {t.dtype}, expected {dtype}")
        require(t.is_contiguous(), name, f"{arg} is not contiguous")


def require_aligned(name: str, **tensors) -> None:
    """Kernel inputs that are read in 16-byte (4- or 8-element) pieces."""
    for arg, t in tensors.items():
        require(t.data_ptr() % 16 == 0, name, f"{arg} is not 16-byte aligned")


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def ptr(t):
    """Device pointer of ``t``, or None (NULL) for no tensor."""
    return None if t is None else t.data_ptr()


def scratch(nbytes: int, device: torch.device):
    """A kernel's global scratch of ``nbytes`` (uninitialised; the kernel
    writes before it reads), or None where it needs none."""
    return torch.empty(nbytes, dtype=torch.uint8, device=device) \
        if nbytes else None


_BARRIERS = {}


def grid_barrier(device: torch.device) -> torch.Tensor:
    """The barrier word of the K1 / K4 grid bodies on ``device``'s current
    stream (csrc/rnn_grid.cuh ``grid_sync``): zeroed once, when first
    asked for, and left ready by every launch, so that no call needs a
    memset (a CUDA graph can capture the launch).  One word a stream: the
    launches on a stream run one after another."""
    key = (device.index, stream(device))
    with _LOCK:
        if key not in _BARRIERS:
            _BARRIERS[key] = torch.zeros(4, dtype=torch.int32, device=device)
        return _BARRIERS[key]
