"""ABX item parsing, feature slicing and triplet group iterators: the
port's own copy of ``cpc_audio_tpu/eval/abx/iterators.py`` (host code,
numpy only), kept line for line so that both packages draw the same
groups.

Group structures are small and irregular (max_size_group ~10), so the
host orchestrates while distances and DTW run in vectorised kernels.
"""

from __future__ import annotations

import math
import random
from itertools import permutations
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np


def normalize_with_singularity(x: np.ndarray) -> np.ndarray:
    """L2-normalize (S, H) (or (N, S, H)) across channels; append an extra
    coordinate that puts null vectors at maximal cosine distance from any
    non-null vector (abx_iterators.py:11-27)."""
    squeeze = x.ndim == 2
    if squeeze:
        x = x[None]
    x = np.array(x, np.float32)
    N, S, H = x.shape
    norm_x = (x ** 2).sum(axis=2, keepdims=True)
    zero_vals = (norm_x == 0)[..., 0]
    with np.errstate(divide="ignore", invalid="ignore"):
        x = x / np.sqrt(norm_x)
    x[zero_vals] = 1.0 / math.sqrt(H)
    border = np.full((N, S, 1), 1e-12, np.float32)
    border[zero_vals] = -2e12
    out = np.concatenate([x, border], axis=2)
    return out[0] if squeeze else out


def load_item_file(path_item_file: str):
    """Parse a ZeroSpeech .item file (abx_iterators.py:30-78).

    Line format: ``#file onset offset #phone prev next speaker``.
    Returns (files_data, context_match, phone_match, speaker_match) with
    interned id maps; files_data[fileID] = [[onset, offset, context_id,
    phone_id, speaker_id], ...].
    """
    with open(path_item_file) as f:
        lines = [l.strip() for l in f.readlines()[1:] if l.strip()]
    out: Dict[str, list] = {}
    phone_match: Dict[str, int] = {}
    speaker_match: Dict[str, int] = {}
    context_match: Dict[str, int] = {}
    for line in lines:
        items = line.split()
        assert len(items) == 7, line
        file_id = items[0]
        out.setdefault(file_id, [])
        onset, offset = float(items[1]), float(items[2])
        context = "+".join([items[4], items[5]])
        phone, speaker = items[3], items[6]
        phone_id = phone_match.setdefault(phone, len(phone_match))
        context_id = context_match.setdefault(context, len(context_match))
        speaker_id = speaker_match.setdefault(speaker, len(speaker_match))
        out[file_id].append([onset, offset, context_id, phone_id, speaker_id])
    return out, context_match, phone_match, speaker_match


def get_features_group(in_data: Sequence, index_order: Sequence[int]):
    """Stable-sort item indices by the given id columns and nest contiguous
    runs per level: the innermost entries are (start, end) ranges over the
    sorted order where all columns are equal; each enclosing level groups
    them by its column prefix.  Same contract as abx_iterators.py:81-112,
    expressed as a lexsort + run-length split.

    Returns (sorted_index, nested_groups).
    """
    n_items, n_levels = len(in_data), len(index_order)
    if n_items == 0:
        return [], []
    keys = np.asarray([[row[i] for i in index_order] for row in in_data])
    # np.lexsort is stable and sorts by its LAST key first -> feed the
    # columns in reverse so column 0 is the primary key, original order
    # breaks ties (matching sorted(..., key=...)).
    order = np.lexsort(tuple(keys[:, c] for c in reversed(range(n_levels))))
    sorted_keys = keys[order]
    # changed[t - 1, c]: column c differs between sorted rows t-1 and t
    changed = sorted_keys[1:] != sorted_keys[:-1]

    def split(level: int, start: int, end: int) -> list:
        """Cut [start, end) wherever any column <= level changes; recurse
        one level deeper inside each run (leaves are (start, end) tuples)."""
        cut_here = changed[start:end - 1, :level + 1].any(axis=1)
        cuts = [start] + list(np.flatnonzero(cut_here) + start + 1) + [end]
        runs = list(zip(cuts[:-1], cuts[1:]))
        if level == n_levels - 1:
            return [(int(s), int(e)) for s, e in runs]
        return [split(level + 1, s, e) for s, e in runs]

    return [int(i) for i in order], split(0, 0, n_items)


class ABXFeatureLoader:
    """Extract per-phone feature segments into one flat array
    (abx_iterators.py:115-246).

    feature_maker(path) -> (1, S, H) or (S, H) features for a file.
    """

    INDEX_CONTEXT = 2
    INDEX_PHONE = 3
    INDEX_SPEAKER = 4

    def __init__(self, path_item_file: str,
                 seq_list: Sequence[Tuple[str, str]],
                 feature_maker: Callable[[str], np.ndarray],
                 step_feature: float, normalize: bool):
        files_data, self.context_match, self.phone_match, \
            self.speaker_match = load_item_file(path_item_file)
        self.step_feature = step_feature
        file_order = [fid for fid, _ in seq_list if fid in files_data]
        features_iter = ((fid, feature_maker(path))
                         for fid, path in seq_list if fid in files_data)
        self._load(files_data, file_order, features_iter, normalize)

    @classmethod
    def from_features_iter(cls, path_item_file: str,
                           file_order: Sequence[str], features_iter,
                           step_feature: float,
                           normalize: bool) -> "ABXFeatureLoader":
        """Build from a stream of ``(file_id, features)`` pairs arriving in
        ANY order (e.g. feature_loader.build_features_batched's
        completion order) while producing the SAME segment layout the
        sequential constructor would in ``file_order`` — so scores stay
        bit-identical to the per-file path.  Each file's item segments
        are sliced out the moment its features arrive and the full
        feature matrix is dropped: peak memory scales with total segment
        frames, not corpus size."""
        self = cls.__new__(cls)
        files_data, self.context_match, self.phone_match, \
            self.speaker_match = load_item_file(path_item_file)
        self.step_feature = step_feature
        order = [fid for fid in file_order if fid in files_data]
        self._load(files_data,
                   order,
                   ((fid, f) for fid, f in features_iter
                    if fid in files_data),
                   normalize)
        return self

    def _cut_segments(self, features, items, normalize):
        """Slice one file's item segments out of its feature matrix.
        Returns ([(loc_size, context_id, phone_id, speaker_id), ...],
        [segment arrays])."""
        features = np.asarray(features)
        if features.ndim == 3:
            features = features.reshape(features.shape[1],
                                        features.shape[2])
        elif features.ndim == 1:
            features = features[:, None]
        if normalize:
            features = normalize_with_singularity(features)
        n_frames = features.shape[0]
        rows, arrays = [], []
        for start, end, context_id, phone_id, speaker_id in items:
            index_start = max(
                0, int(math.ceil(self.step_feature * start - 0.5)))
            index_end = min(
                n_frames, int(math.floor(self.step_feature * end - 0.5)))
            if index_start >= n_frames or index_end <= index_start:
                continue
            rows.append((index_end - index_start, context_id, phone_id,
                         speaker_id))
            # copy so the parent matrix can be freed between files
            arrays.append(np.array(features[index_start:index_end]))
        return rows, arrays

    def _load(self, files_data, file_order, features_iter, normalize):
        # Consume the stream (any order), keeping only item segments …
        segments = {}
        for file_id, features in features_iter:
            segments[file_id] = self._cut_segments(
                features, files_data[file_id], normalize)
        # … then assemble in file_order, matching the sequential layout.
        self.features: List[list] = []
        data = []
        tot_size = 0
        for file_id in file_order:
            if file_id not in segments:
                continue
            rows, arrays = segments.pop(file_id)
            for (loc_size, context_id, phone_id, speaker_id), arr \
                    in zip(rows, arrays):
                self.features.append([tot_size, loc_size, context_id,
                                      phone_id, speaker_id])
                data.append(arr)
                tot_size += loc_size
        self.data = np.concatenate(data, axis=0) if data \
            else np.zeros((0, 1), np.float32)
        self.feature_dim = self.data.shape[1]

    def get_ids(self, index: int):
        return tuple(self.features[index][2:])

    def __getitem__(self, index: int):
        i_data, out_size, context_id, phone_id, speaker_id = \
            self.features[index]
        return (self.data[i_data:i_data + out_size], out_size,
                (context_id, phone_id, speaker_id))

    def __len__(self) -> int:
        return len(self.features)

    def get_n_speakers(self) -> int:
        return len(self.speaker_match)

    def get_n_context(self) -> int:
        return len(self.context_match)

    def get_n_phone(self) -> int:
        return len(self.phone_match)

    def get_iterator(self, mode: str, max_size_group: int):
        if mode == "within":
            return ABXWithinGroupIterator(self, max_size_group)
        if mode == "across":
            return ABXAcrossGroupIterator(self, max_size_group)
        raise ValueError(f"Invalid mode: {mode}")


class ABXIterator:
    """Base triplet iterator (abx_iterators.py:249-297)."""

    def __init__(self, abx_dataset: ABXFeatureLoader, max_size_group: int,
                 seed: int = 0):
        self.max_size_group = max_size_group
        self.dataset = abx_dataset
        self.len = 0
        self.rng = random.Random(seed)
        self.index_csp, self.groups_csp = get_features_group(
            abx_dataset.features,
            [abx_dataset.INDEX_CONTEXT, abx_dataset.INDEX_SPEAKER,
             abx_dataset.INDEX_PHONE])

    def get_group(self, i_start: int, i_end: int):
        """Pack one group into (N, max_size, H) + sizes, subsampled to
        max_size_group (abx_iterators.py:265-288 semantics)."""
        picks = list(range(i_start, i_end))
        if len(picks) > self.max_size_group:
            picks = self.rng.sample(picks, k=self.max_size_group)
        segments = [self.dataset[self.index_csp[i]] for i in picks]
        sizes = np.fromiter((s for _, s, _ in segments), np.int64,
                            count=len(segments))
        out_data = np.zeros((len(segments), int(sizes.max()),
                             self.dataset.feature_dim), np.float32)
        for row, (seg, size, _) in enumerate(segments):
            out_data[row, :size] = seg
        # every item in a group shares (context, phone, speaker) ids
        return out_data, sizes, segments[-1][2]

    def __len__(self) -> int:
        return self.len

    def get_board_size(self):
        raise NotImplementedError


class ABXWithinGroupIterator(ABXIterator):
    """Triplets for the within-speaker score (abx_iterators.py:300-349):
    same context+speaker, phone a != b, X drawn from A's group."""

    def __init__(self, abx_dataset, max_size_group, seed: int = 0):
        super().__init__(abx_dataset, max_size_group, seed)
        self.symmetric = True
        # A needs >= 2 items (X is drawn from A's group); B any other phone
        # in the same (context, speaker) cell.
        self.len = sum(
            (len(speaker_group) - 1)
            for context_group in self.groups_csp
            for speaker_group in context_group if len(speaker_group) > 1
            for s, e in speaker_group if e - s > 1)

    def __iter__(self):
        for context_group in self.groups_csp:
            for speaker_group in context_group:
                if len(speaker_group) <= 1:
                    continue
                for group_a, group_b in permutations(speaker_group, 2):
                    if group_a[1] - group_a[0] <= 1:
                        continue
                    data_a, size_a, id_a = self.get_group(*group_a)
                    data_b, size_b, id_b = self.get_group(*group_b)
                    coords = (id_a[2], id_a[1], id_b[1], id_a[0])
                    yield (coords, (data_a, size_a), (data_b, size_b),
                           (data_a, size_a))

    def get_board_size(self):
        return (self.dataset.get_n_speakers(), self.dataset.get_n_phone(),
                self.dataset.get_n_phone(), self.dataset.get_n_context())


class ABXAcrossGroupIterator(ABXIterator):
    """Triplets for the across-speaker score (abx_iterators.py:352-434):
    X = same context+phone as A from up to max_x other speakers."""

    def __init__(self, abx_dataset, max_size_group, max_x: int = 5,
                 seed: int = 0):
        super().__init__(abx_dataset, max_size_group, seed)
        self.symmetric = False
        self.max_x = max_x
        # (context, phone) -> {speaker: leaf range}; X candidates for a
        # group are the same (context, phone) under a different speaker.
        self.speakers_by_cp: Dict[tuple, Dict[int, tuple]] = {}
        for group in self._leaf_groups():
            c_id, p_id, s_id = self._group_ids(group)
            self.speakers_by_cp.setdefault((c_id, p_id), {})[s_id] = group
        self.len = sum(
            (len(speaker_group) - 1) * min(self.max_x,
                                           len(self._x_candidates(group)))
            for context_group in self.groups_csp
            for speaker_group in context_group if len(speaker_group) > 1
            for group in speaker_group)

    def _leaf_groups(self):
        for context_group in self.groups_csp:
            for speaker_group in context_group:
                yield from speaker_group

    def _group_ids(self, group):
        return self.dataset.get_ids(self.index_csp[group[0]])

    def _x_candidates(self, group):
        c_id, p_id, s_id = self._group_ids(group)
        return [g for spk, g in self.speakers_by_cp[(c_id, p_id)].items()
                if spk != s_id]

    def __iter__(self):
        for context_group in self.groups_csp:
            for speaker_group in context_group:
                if len(speaker_group) <= 1:
                    continue
                for i_a, group_a in enumerate(speaker_group):
                    candidates = self._x_candidates(group_a)
                    if len(candidates) > self.max_x:
                        candidates = self.rng.sample(candidates, k=self.max_x)
                    for group_x in candidates:
                        for i_b, group_b in enumerate(speaker_group):
                            if i_b == i_a:
                                continue
                            data_a, size_a, id_a = self.get_group(*group_a)
                            data_b, size_b, id_b = self.get_group(*group_b)
                            data_x, size_x, id_x = self.get_group(*group_x)
                            coords = (id_a[2], id_a[1], id_b[1], id_a[0],
                                      id_x[2])
                            yield (coords, (data_a, size_a),
                                   (data_b, size_b), (data_x, size_x))

    def get_board_size(self):
        return (self.dataset.get_n_speakers(), self.dataset.get_n_phone(),
                self.dataset.get_n_phone(), self.dataset.get_n_context(),
                self.dataset.get_n_speakers())
