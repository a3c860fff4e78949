"""Streaming audio dataset: speaker-tree discovery, pack streaming, samplers.

The port's own copy of ``cpc_audio_tpu/data/dataset.py`` (CPC_audio
dataset.py).  Design:
  * One flat float32 numpy buffer per pack with prefix-sum interval tables
    (same memory model as the reference, dataset.py:139-171) — but batches
    are produced by a single vectorized gather into a fixed-shape
    (B, 1, sizeWindow) array instead of per-item ``__getitem__`` calls, so
    the host never becomes the bottleneck feeding the device.
  * Audio decode goes through the native C++ FLAC/WAV decoder
    (ops/native.py) on a thread pool — ctypes releases the GIL, giving
    process-pool throughput without pickling (the reference needed a
    multiprocessing Pool around soundfile, dataset.py:52).
  * Samplers are numpy index-matrix generators: a whole epoch's batch plan
    ``(n_batches, B)`` of window starts is materialized up-front.
  * Pack streaming keeps the reference's async next-pack prefetch
    (dataset.py:121-137) via a background executor.

Reference-name aliases (findAllSeqs, filterSeqs, parseSeqLabels) are exported
for API parity.
"""

from __future__ import annotations

import json
import os
import random
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .audio_io import decode_file, file_length


# ---------------------------------------------------------------------------
# Discovery / filtering / labels (dataset.py:417-520)
# ---------------------------------------------------------------------------

CACHE_NAME = "_seqs_cache.json"


def find_all_seqs(dir_name: str, extension: str = ".flac",
                  load_cache: bool = False, speaker_level: int = 1,
                  ) -> Tuple[List[Tuple[int, str]], List[str]]:
    """Walk the ``speaker/.../file.ext`` tree (dataset.py:417-490).

    Returns ([(speaker_idx, rel_path)], speaker_names).  The speaker label is
    the first ``speaker_level`` path components; 0 maps every file to one
    unlabeled group.  Caches to a JSON sidecar (the reference cached a torch
    pickle to ``_seqs_cache.txt``).
    """
    cache_path = os.path.join(dir_name, CACHE_NAME)
    if load_cache and os.path.exists(cache_path):
        try:
            with open(cache_path) as f:
                d = json.load(f)
            return [tuple(x) for x in d["sequences"]], d["speakers"]
        except (OSError, ValueError, KeyError):
            pass

    if not dir_name.endswith(os.sep):
        dir_name += os.sep
    prefix = len(dir_name)
    speakers_target: Dict[str, int] = {}
    out_sequences: List[Tuple[int, str]] = []
    for root, dirs, filenames in os.walk(dir_name):
        dirs.sort()
        filtered = sorted(f for f in filenames if f.endswith(extension))
        if not filtered:
            continue
        speaker_str = os.sep.join(
            root[prefix:].split(os.sep)[:speaker_level])
        if speaker_str not in speakers_target:
            speakers_target[speaker_str] = len(speakers_target)
        speaker = speakers_target[speaker_str]
        for filename in filtered:
            out_sequences.append((speaker,
                                  os.path.join(root[prefix:], filename)))
    out_speakers: List[str] = [""] * len(speakers_target)
    for key, index in speakers_target.items():
        out_speakers[index] = key
    try:
        with open(cache_path, "w") as f:
            json.dump({"sequences": out_sequences,
                       "speakers": out_speakers}, f)
    except OSError:
        pass
    return out_sequences, out_speakers


def filter_seqs(path_txt: str, seq_couples: List[Tuple[int, str]]
                ) -> List[Tuple[int, str]]:
    """Keep sequences whose basename stem is listed in a split file
    (dataset.py:505-520; two-pointer merge over sorted lists)."""
    with open(path_txt) as f:
        in_seqs = sorted(line.strip() for line in f if line.strip())
    couples = sorted(
        seq_couples,
        key=lambda x: os.path.basename(os.path.splitext(x[1])[0]))
    output, index = [], 0
    for x in couples:
        seq = os.path.basename(os.path.splitext(x[1])[0])
        while index < len(in_seqs) and seq > in_seqs[index]:
            index += 1
        if index == len(in_seqs):
            break
        if seq == in_seqs[index]:
            output.append(x)
    return output


def parse_seq_labels(path_labels: str) -> Tuple[dict, int]:
    """Parse frame-aligned phone labels (dataset.py:493-502).

    Returns ({"step": 160, seq_name: [labels...]}, n_phones)."""
    output = {"step": 160}  # 160 samples = 10 ms @ 16 kHz
    max_phone = 0
    with open(path_labels) as f:
        for line in f:
            data = line.split()
            if not data:
                continue
            output[data[0]] = [int(x) for x in data[1:]]
            max_phone = max(max_phone, max(output[data[0]]))
    return output, max_phone + 1


# ---------------------------------------------------------------------------
# Samplers: epoch batch plans as (n_batches, B) index matrices
# ---------------------------------------------------------------------------

def uniform_batch_plan(data_size: int, size_window: int, batch_size: int,
                       offset: int, rng: random.Random) -> np.ndarray:
    """Random permutation of non-overlapping windows (dataset.py:318-336),
    grouped into full batches (drop_last=True, dataset.py:225)."""
    n = data_size // size_window
    if offset > 0:
        n -= 1
    starts = offset + size_window * np.asarray(
        rng.sample(range(n), n), np.int64)
    n_batches = len(starts) // batch_size
    return starts[:n_batches * batch_size].reshape(n_batches, batch_size)


def sequential_batch_plan(data_size: int, size_window: int, batch_size: int,
                          offset: int) -> np.ndarray:
    """Batch row b reads contiguous windows from lane b of the stream
    (dataset.py:339-358) — enables stateful hidden carry-over."""
    n = (data_size // size_window) // batch_size
    if offset > 0:
        n -= 1
    lane = data_size // batch_size
    idx = np.arange(n)[:, None] * size_window + \
        np.arange(batch_size)[None, :] * lane + offset
    return idx.astype(np.int64)


def same_speaker_batch_plan(intervals: np.ndarray, size_window: int,
                            batch_size: int, offset: int,
                            rng: random.Random) -> np.ndarray:
    """All windows of a batch come from one interval (speaker or sequence)
    (dataset.py:361-408).  Ragged tail batches are completed by re-sampling
    windows from the same interval (the reference emitted ragged batches;
    fixed shapes are required for XLA)."""
    if intervals[0] != 0:
        raise ValueError("Sampling intervals should start at zero")
    sizes = (np.diff(intervals) // size_window).astype(np.int64)
    if offset > 0:
        sizes = np.maximum(0, sizes - 1)
    batches = []
    for i, n in enumerate(sizes):
        if n <= 0:
            continue
        perm = np.asarray(rng.sample(range(int(n)), int(n)), np.int64)
        start = 0
        while start < n:
            chunk = perm[start:start + batch_size]
            start += batch_size
            if len(chunk) < batch_size:
                if int(n) >= batch_size:
                    extra = np.asarray(
                        rng.sample(range(int(n)), batch_size - len(chunk)),
                        np.int64)
                else:
                    extra = np.asarray(
                        [rng.randrange(int(n))
                         for _ in range(batch_size - len(chunk))], np.int64)
                chunk = np.concatenate([chunk, extra])
            batches.append(offset + chunk * size_window + intervals[i])
    if not batches:
        return np.zeros((0, batch_size), np.int64)
    plan = np.stack(batches)
    perm = rng.sample(range(len(plan)), len(plan))
    return plan[perm]


# ---------------------------------------------------------------------------
# AudioBatchData
# ---------------------------------------------------------------------------

class AudioBatchData:
    """Pack-streaming dataset over a flat sample buffer (dataset.py:20-258).

    Batches: ``(windows (B, 1, sizeWindow) f32, labels (B,) or (B, F) i32)``.
    """

    def __init__(self, path: str, size_window: int,
                 seq_names: Sequence[Tuple[int, str]],
                 phone_labels_dict: Optional[dict], n_speakers: int,
                 n_process_loader: int = 8,
                 max_size_loaded: int = 4_000_000_000,
                 seed: Optional[int] = None):
        self.db_path = path
        self.size_window = size_window
        self.seq_names = [(s, os.path.join(path, p)) for s, p in seq_names]
        if not self.seq_names:
            # would otherwise surface as an obscure IndexError in pack
            # loading; a typo'd split file is the usual cause
            raise ValueError(
                f"AudioBatchData got an empty sequence list for {path} — "
                "check the split file names against the database contents")
        self.n_speakers = n_speakers
        self.max_size_loaded = max_size_loaded
        self._rng = random.Random(seed)
        self._pool = ThreadPoolExecutor(max_workers=n_process_loader)

        self.phone_labels_dict = phone_labels_dict
        self.phone_size = 0 if phone_labels_dict is None \
            else phone_labels_dict["step"]
        self.phone_step = 0 if phone_labels_dict is None \
            else size_window // self.phone_size
        self.double_labels = False

        self._prepare()
        self._pending: Optional[Future] = None
        # seconds spent BLOCKED waiting for the prefetched pack, one entry
        # per swap (index 0 is the unavoidable cold-start load) — the
        # loader-starvation metric for the scale soak (perf/soak_loader.py)
        self.stall_log: List[float] = []
        self.current_pack = -1
        self.next_pack = 0
        self._start_load(self.next_pack)
        self.load_next_pack()

    # -- pack management ---------------------------------------------------
    def _prepare(self):
        """Shuffle files, measure lengths, split into packs
        (dataset.py:91-116)."""
        self._rng.shuffle(self.seq_names)
        lengths = list(self._pool.map(
            lambda sp: file_length(sp[1]), self.seq_names))
        self.package_index: List[Tuple[int, int]] = []
        self.tot_size = 0
        start, pack_size = 0, 0
        for index, length in enumerate(lengths):
            pack_size += length
            if pack_size > self.max_size_loaded:
                self.package_index.append((start, index))
                self.tot_size += pack_size
                start, pack_size = index, 0
        if pack_size > 0:
            self.package_index.append((start, len(self.seq_names)))
            self.tot_size += pack_size

    def _decode_one(self, item):
        speaker, full_path = item
        seq_name = os.path.splitext(os.path.basename(full_path))[0]
        data = decode_file(full_path)       # (n,) mono float32
        return speaker, seq_name, data

    def _start_load(self, pack: int):
        seq_start, seq_end = self.package_index[pack]
        names = list(self.seq_names[seq_start:seq_end])

        def load():
            return list(self._pool.map(self._decode_one, names))

        self._pending = ThreadPoolExecutor(max_workers=1).submit(load)

    def load_next_pack(self):
        """Swap in the prefetched pack; start loading the following one
        (dataset.py:121-137)."""
        self.current_pack = self.next_pack
        assert self._pending is not None
        t0 = time.perf_counter()
        next_data = self._pending.result()
        self.stall_log.append(time.perf_counter() - t0)
        self._parse_data_block(next_data)
        self.next_pack = (self.current_pack + 1) % len(self.package_index)
        if self.next_pack == 0 and len(self.package_index) > 1:
            self._prepare()
        self._start_load(self.next_pack)

    def _parse_data_block(self, next_data):
        """Sort by (speaker, name), concat into the flat buffer, build
        interval tables (dataset.py:139-171)."""
        next_data.sort(key=lambda x: (x[0], x[1]))
        speaker_label = [0]
        seq_label = [0]
        phone_labels: List[int] = []
        chunks = []
        speaker_size = 0
        index_speaker = 0
        for speaker, seq_name, seq in next_data:
            while index_speaker < speaker:
                index_speaker += 1
                speaker_label.append(speaker_size)
            if index_speaker != speaker:
                raise ValueError(f"{speaker} invalid speaker")
            if self.phone_labels_dict is not None:
                if seq_name not in self.phone_labels_dict:
                    raise KeyError(f"No phone labels for {seq_name}")
                phone_labels += self.phone_labels_dict[seq_name]
                new_size = len(self.phone_labels_dict[seq_name]) \
                    * self.phone_size
                seq = seq[:new_size]
            chunks.append(seq)
            seq_label.append(seq_label[-1] + len(seq))
            speaker_size += len(seq)
        while index_speaker < self.n_speakers - 1:
            index_speaker += 1
            speaker_label.append(speaker_size)
        speaker_label.append(speaker_size)
        self.data = (np.concatenate(chunks) if chunks
                     else np.zeros(0, np.float32))
        self.speaker_label = np.asarray(speaker_label, np.int64)
        self.seq_label = np.asarray(seq_label, np.int64)
        self.phone_labels = np.asarray(phone_labels, np.int64)

    def reset_phone_labels(self, new_phone_labels: dict, step: int) -> None:
        """Swap the phone-label dictionary (dataset.py:68-72)."""
        self.phone_size = step
        self.phone_step = self.size_window // step
        self.phone_labels_dict = dict(new_phone_labels)
        self.load_next_pack()

    # -- accessors ----------------------------------------------------------
    def get_seq_names(self) -> List[str]:
        """Absolute paths of the dataset's sequences (dataset.py:78-79)."""
        return [p for _, p in self.seq_names]

    def get_n_speakers(self) -> int:
        return self.n_speakers

    def get_n_seqs(self) -> int:
        return len(self.seq_label) - 1

    def get_n_loads_per_epoch(self) -> int:
        return len(self.package_index)

    def __len__(self) -> int:
        return self.tot_size // self.size_window

    def get_speaker_label(self, idx: int) -> int:
        return int(np.searchsorted(self.speaker_label, idx, "right") - 1)

    # -- batch extraction (vectorized __getitem__) ---------------------------
    def gather_batch(self, starts: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """starts (B,) -> (windows (B, 1, W) f32, labels).

        Labels are speaker ids (B,) — or phone-label windows (B, W//160)
        when phone labels are attached (dataset.py:185-202); double_labels
        returns (windows, speaker, phone)."""
        B = len(starts)
        W = self.size_window
        idx = starts[:, None] + np.arange(W)[None, :]
        windows = self.data[idx][:, None, :]  # (B, 1, W)
        speakers = (np.searchsorted(self.speaker_label, starts, "right")
                    - 1).astype(np.int64)
        if self.phone_size > 0:
            pidx = (starts // self.phone_size)[:, None] \
                + np.arange(self.phone_step)[None, :]
            phones = self.phone_labels[pidx].astype(np.int64)
            if self.double_labels:
                return windows, speakers, phones
            return windows, phones
        return windows, speakers

    # -- epoch iteration ------------------------------------------------------
    def get_base_plan(self, sampling_type: str, batch_size: int,
                      offset: int) -> np.ndarray:
        if sampling_type == "samespeaker":
            return same_speaker_batch_plan(self.speaker_label,
                                           self.size_window, batch_size,
                                           offset, self._rng)
        if sampling_type == "samesequence":
            return same_speaker_batch_plan(self.seq_label, self.size_window,
                                           batch_size, offset, self._rng)
        if sampling_type == "sequential":
            return sequential_batch_plan(len(self.data), self.size_window,
                                         batch_size, offset)
        return uniform_batch_plan(len(self.data), self.size_window,
                                  batch_size, offset, self._rng)

    def get_data_loader(self, batch_size: int, sampling_type: str,
                        random_offset: bool, num_workers: int = 0,
                        on_loop: int = -1) -> "AudioLoader":
        """Epoch loader over all packs (dataset.py:227-258).

        ``len(loader)`` is the non-overlapping-window ESTIMATE
        ``tot_size // (size_window * batch_size)``; the actual batch
        count is only known as per-pack plans are built and exceeds the
        estimate under samespeaker/samesequence sampling (ragged tail
        batches are completed by re-sampling, one per interval per
        pack — see same_speaker_batch_plan)."""
        n_loops = len(self.package_index)
        tot = self.tot_size // (self.size_window * batch_size)
        if on_loop >= 0:
            self.next_pack = on_loop
            self.load_next_pack()
            n_loops = 1

        def plan_call():
            offset = self._rng.randint(0, self.size_window // 2) \
                if random_offset else 0
            return self.get_base_plan(sampling_type, batch_size, offset)

        return AudioLoader(self, plan_call, n_loops, self.load_next_pack, tot)


class AudioLoader:
    """Iterates packs x batch plans (dataset.py:272-315)."""

    def __init__(self, dataset: AudioBatchData, plan_call, n_loop: int,
                 update_call, size: int):
        self.dataset = dataset
        self.plan_call = plan_call
        self.n_loop = n_loop
        self.update_call = update_call
        self.size = size

    def __len__(self) -> int:
        return self.size

    def __iter__(self) -> Iterator:
        for i in range(self.n_loop):
            plan = self.plan_call()
            for b in range(plan.shape[0]):
                yield self.dataset.gather_batch(plan[b])
            if i < self.n_loop - 1:
                self.update_call()


# Reference-name aliases ----------------------------------------------------
findAllSeqs = find_all_seqs
filterSeqs = filter_seqs
parseSeqLabels = parse_seq_labels
