"""Audio file IO: native decode with python fallback for WAV (the port's
own copy of ``cpc_audio_tpu/data/audio_io.py``).

The decode path is the native C++ FLAC/WAV decoder (native/audio.cc),
MD5-validated against each FLAC file's STREAMINFO signature; stereo files
collapse to mono by channel mean (reference dataset.py:267-268).
"""

from __future__ import annotations

import wave
from typing import Tuple

import numpy as np

from ..ops import native


def decode_file(path: str, target_rate: int = 0) -> np.ndarray:
    """Decode to mono float32 samples (n,)."""
    if native.available():
        data, rate = native.decode_audio(path)
    else:
        data, rate = _decode_wav_py(path)
    if data.ndim == 2:
        if data.shape[1] > 1:
            data = data.mean(axis=1)
        else:
            data = data[:, 0]
    if target_rate and rate != target_rate:
        raise ValueError(f"{path}: rate {rate} != required {target_rate}; "
                         f"resample first (eval/adjust_sample_rate.py)")
    return np.ascontiguousarray(data, np.float32)


def decode_file_with_rate(path: str) -> Tuple[np.ndarray, int]:
    if native.available():
        data, rate = native.decode_audio(path)
    else:
        data, rate = _decode_wav_py(path)
    if data.ndim == 2:
        data = data.mean(axis=1) if data.shape[1] > 1 else data[:, 0]
    return np.ascontiguousarray(data, np.float32), rate


def file_length(path: str) -> int:
    """Number of frames without decoding (reference extractLength,
    dataset.py:411-414)."""
    if native.available():
        n, _, _ = native.audio_info(path)
        return n
    with wave.open(path, "rb") as w:
        return w.getnframes()


def _decode_wav_py(path: str) -> Tuple[np.ndarray, int]:
    with wave.open(path, "rb") as w:
        n, ch, width = w.getnframes(), w.getnchannels(), w.getsampwidth()
        rate = w.getframerate()
        raw = w.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, "u1").astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV width {width}")
    return data.reshape(n, ch), rate
