"""Resample audio clips (e.g. Common Voice mp3 -> wav) to a target rate:
the port's own copy of ``cpc_audio_tpu/eval/adjust_sample_rate.py`` (host
code: ``scipy.signal.resample_poly``, polyphase windowed-sinc, 16-bit
WAV output), reading through the port's ``data/audio_io``.

mp3 input is decoded natively (native/audio.cc routes mp3 through the
system's libmpg123), as the reference consumed Common Voice's mp3.

Usage:
    python -m cpc_audio_tpu_torch.eval.adjust_sample_rate DB PHONE_LIST OUT
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import wave
from typing import List

import numpy as np

from ..data.audio_io import decode_file_with_rate


def write_wav(path: str, data: np.ndarray, rate: int) -> None:
    pcm = np.clip(data, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1 if pcm.ndim == 1 else pcm.shape[1])
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())


def resample(data: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    if orig_sr == target_sr:
        return data
    from scipy.signal import resample_poly
    g = math.gcd(orig_sr, target_sr)
    return resample_poly(data, target_sr // g, orig_sr // g).astype(
        np.float32)


def adjust_sample_rate(path_db: str, file_list: List[str], path_db_out: str,
                       target_sr: int) -> None:
    for item in file_list:
        path_in = os.path.join(path_db, item)
        path_out = os.path.join(
            path_db_out, os.path.splitext(item)[0] + ".wav")
        data, sr = decode_file_with_rate(path_in)
        write_wav(path_out, resample(data, sr, target_sr), target_sr)


def get_names_list(path_tsv_file: str) -> List[str]:
    with open(path_tsv_file) as f:
        return [x.split()[0] for x in f if x.strip()]


def parse_args(argv):
    parser = argparse.ArgumentParser(
        description="Adjust the sample rate of a group of audio files")
    parser.add_argument("path_db", type=str)
    parser.add_argument("path_phone_files", type=str)
    parser.add_argument("path_out", type=str)
    parser.add_argument("--out_sample_rate", type=int, default=16000)
    # reference default (adjust_sample_rate.py:58): Common Voice ships mp3
    parser.add_argument("--file_extension", type=str, default=".mp3")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv if argv is not None else sys.argv[1:])
    file_list_db = sorted(f for f in os.listdir(args.path_db)
                          if os.path.splitext(f)[1] == args.file_extension)
    print(f"Found {len(file_list_db)} in the dataset")
    file_list_phone = sorted(get_names_list(args.path_phone_files))
    print(f"Found {len(file_list_phone)} with a phone transcription")

    out_list = []
    index_phone = 0
    for file_name in file_list_db:
        stem = os.path.splitext(file_name)[0]
        while index_phone < len(file_list_phone) \
                and stem > file_list_phone[index_phone]:
            index_phone += 1
        if index_phone >= len(file_list_phone):
            break
        if stem == file_list_phone[index_phone]:
            out_list.append(file_name)

    print(f"Converting {len(out_list)} files")
    os.makedirs(args.path_out, exist_ok=True)
    adjust_sample_rate(args.path_db, out_list, args.path_out,
                       args.out_sample_rate)
    return 0


if __name__ == "__main__":
    sys.exit(main())
