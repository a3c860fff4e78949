"""ctypes bindings to the native C++ host library (libcpc_native.so): the
port's own copy of ``cpc_audio_tpu/ops/native.py``.

The library is built from the repository's top-level ``native/*.cc`` (by
``make -C native``, on first use), which both packages share.  It provides the
host-side hot kernels that the reference implemented natively or ran in pure
Python hot loops:
  * batched normalized DTW (reference Cython dtw.pyx:16-77)
  * CTC prefix beam search (reference pure-python seq_alignment.py:11-61)
  * Needleman-Wunsch alignment score (seq_alignment.py:89-113)
  * FLAC/WAV audio decode (reference used libsndfile via python-soundfile)

All entry points degrade gracefully: callers check ``available()`` and fall
back to python implementations.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_LOAD_LOCK = threading.Lock()

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_ROOT, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libcpc_native.so")

_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")


def _build() -> bool:
    try:
        r = subprocess.run(["make", "-s", "-C", _NATIVE_DIR],
                           capture_output=True, timeout=300)
        return r.returncode == 0
    except Exception:
        return False


def _load() -> Optional[ctypes.CDLL]:
    # Lock-free fast path checks ONLY _LIB (assigned last, fully
    # constructed); everything else funnels through the lock.  The lock
    # matters: the first native use in a process is often a *thread
    # pool* (AudioBatchData's length scan maps file_length across
    # workers) — before it, `_TRIED = True` was set at load START, so a
    # second thread arriving mid-load saw `_TRIED and _LIB is None`,
    # took the python-WAV fallback, and crashed on FLAC corpora (flaky,
    # observed live on the probe CLI).
    if _LIB is not None:
        return _LIB
    with _LOAD_LOCK:
        return _load_locked()


def _load_locked() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    try:
        _LIB = _load_attempt()
    finally:
        _TRIED = True  # only after the attempt: don't retry failed builds
    return _LIB


def _load_attempt() -> Optional[ctypes.CDLL]:
    if not os.path.exists(_LIB_PATH) and os.path.exists(_NATIVE_DIR):
        _build()
    if not os.path.exists(_LIB_PATH):
        return None
    lib = ctypes.CDLL(_LIB_PATH)

    lib.cpc_dtw_batch.restype = None
    lib.cpc_dtw_batch.argtypes = [
        _f32p, ctypes.c_int, ctypes.c_int,            # dist (N1*N2, S1, S2)
        _i64p, _i64p, ctypes.c_int, ctypes.c_int,     # sx (N1,), sy (N2,)
        ctypes.c_bool, _f32p,                          # symmetric, out
    ]

    lib.cpc_beam_search.restype = ctypes.c_int
    lib.cpc_beam_search.argtypes = [
        _f32p, ctypes.c_int, ctypes.c_int,             # preds (T, P)
        ctypes.c_int, ctypes.c_int,                    # n_keep, blank
        _i32p, _i32p, _f64p,                           # out_labels, sizes, scores
    ]

    lib.cpc_needleman_wunsch.restype = ctypes.c_double
    lib.cpc_needleman_wunsch.argtypes = [
        _i32p, ctypes.c_int, _i32p, ctypes.c_int,
    ]

    lib.cpc_decode_audio.restype = ctypes.c_longlong
    lib.cpc_decode_audio.argtypes = [
        ctypes.c_char_p,                               # path
        ctypes.POINTER(ctypes.c_int),                  # sample_rate out
        ctypes.POINTER(ctypes.c_int),                  # channels out
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),  # data out (malloc'd)
    ]
    lib.cpc_free.restype = None
    lib.cpc_free.argtypes = [ctypes.POINTER(ctypes.c_float)]

    lib.cpc_audio_info.restype = ctypes.c_longlong
    lib.cpc_audio_info.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]

    return lib


def available() -> bool:
    return _load() is not None


# ---------------------------------------------------------------------------
# DTW
# ---------------------------------------------------------------------------

def dtw_batch(dist: np.ndarray, sx: np.ndarray, sy: np.ndarray,
              symmetric: bool) -> np.ndarray:
    """Batched path-normalized DTW over precomputed frame distances.

    dist: (N1, N2, S1, S2) float32; sx: (N1,), sy: (N2,) true lengths.
    Returns (N1, N2) normalized DTW costs (dtw.pyx:40-77 semantics).
    """
    lib = _load()
    assert lib is not None
    N1, N2, S1, S2 = dist.shape
    dist = np.ascontiguousarray(dist.reshape(N1 * N2, S1, S2), np.float32)
    out = np.zeros((N1, N2), np.float32)
    lib.cpc_dtw_batch(dist.reshape(-1), S1, S2,
                      np.ascontiguousarray(sx, np.int64),
                      np.ascontiguousarray(sy, np.int64), N1, N2,
                      symmetric, out.reshape(-1))
    return out


# ---------------------------------------------------------------------------
# Beam search
# ---------------------------------------------------------------------------

def beam_search(score_preds: np.ndarray, n_keep: int, blank_label: int
                ) -> List[Tuple[float, List[int]]]:
    lib = _load()
    assert lib is not None
    T, P = score_preds.shape
    max_len = T
    out_labels = np.zeros((n_keep, max_len), np.int32)
    out_sizes = np.zeros(n_keep, np.int32)
    out_scores = np.zeros(n_keep, np.float64)
    n = lib.cpc_beam_search(
        np.ascontiguousarray(score_preds, np.float32), T, P,
        n_keep, blank_label,
        out_labels.reshape(-1), out_sizes, out_scores)
    return [(float(out_scores[i]), out_labels[i, :out_sizes[i]].tolist())
            for i in range(n)]


def needleman_wunsch(seq1: np.ndarray, seq2: np.ndarray) -> float:
    lib = _load()
    assert lib is not None
    s1 = np.ascontiguousarray(seq1, np.int32)
    s2 = np.ascontiguousarray(seq2, np.int32)
    return float(lib.cpc_needleman_wunsch(s1, len(s1), s2, len(s2)))


# ---------------------------------------------------------------------------
# Audio decode
# ---------------------------------------------------------------------------

def decode_audio(path: str) -> Tuple[np.ndarray, int]:
    """Decode a FLAC/WAV file -> (float32 samples (n, channels), rate)."""
    lib = _load()
    assert lib is not None
    sr = ctypes.c_int(0)
    ch = ctypes.c_int(0)
    ptr = ctypes.POINTER(ctypes.c_float)()
    n = lib.cpc_decode_audio(path.encode(), ctypes.byref(sr),
                             ctypes.byref(ch), ctypes.byref(ptr))
    if n < 0:
        raise IOError(f"native decode failed for {path} (code {n})")
    try:
        buf = np.ctypeslib.as_array(ptr, shape=(int(n) * ch.value,))
        data = np.array(buf, np.float32).reshape(int(n), ch.value)
    finally:
        lib.cpc_free(ptr)
    return data, sr.value


def audio_info(path: str) -> Tuple[int, int, int]:
    """(n_frames, sample_rate, channels) without decoding samples."""
    lib = _load()
    assert lib is not None
    sr = ctypes.c_int(0)
    ch = ctypes.c_int(0)
    n = lib.cpc_audio_info(path.encode(), ctypes.byref(sr), ctypes.byref(ch))
    if n < 0:
        raise IOError(f"native info failed for {path} (code {n})")
    return int(n), sr.value, ch.value
