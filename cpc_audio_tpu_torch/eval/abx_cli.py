"""ZeroSpeech ABX evaluation CLI of the port (cpc_audio_tpu/eval/
abx_cli.py).

Usage:
    python -m cpc_audio_tpu_torch.eval.abx_cli from_checkpoint CKPT ITEM DB
    python -m cpc_audio_tpu_torch.eval.abx_cli from_pre_computed ITEM FEATS

``from_checkpoint`` extracts the features on the card (``load_model``,
``FeatureModule(keep_hidden=True)``; with ``--batch_lanes`` > 1 and not
``--strict``, lane-packed by ``build_features_batched`` and streamed into
the loader); ``--on_device`` runs the DTW on the card too, where the
default is the native host kernel.  ``main(argv, device="cpu")`` runs on
the CPU.  Writes ``ABX_scores.json`` and ``ABX_args.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..data import find_all_seqs
from ..feature_loader import (FeatureModule, build_feature,
                              build_features_batched, load_model)
from .abx import group_computation as abx_g
from .abx import iterators as abx_it


def reduce_scores(coords: List[tuple], values: List[float],
                  board_size: tuple, n_context_dims: int) -> float:
    """Aggregate the sparse (speaker, phoneA, phoneB, context[, speakerX])
    scores as the reference's sparse-tensor pipeline does: the mean over
    contexts, then speakers, then phone pairs."""
    S, p1, p2 = board_size[:3]
    sums = np.zeros((S, p1, p2), np.float64)
    counts = np.zeros((S, p1, p2), np.float64)
    for c, v in zip(coords, values):
        sums[c[0], c[1], c[2]] += v
        counts[c[0], c[1], c[2]] += 1.0
    group_confusion = sums / (1e-8 * (counts == 0) + counts)
    index_speaker = counts > 0
    divisor_speaker = index_speaker.sum(axis=0)
    phone_confusion = group_confusion.sum(axis=0) / (
        1e-8 * (divisor_speaker == 0) + divisor_speaker)
    return float(phone_confusion.sum() / (divisor_speaker > 0).sum())


def abx(feature_function, path_item_file: str,
        seq_list: Sequence[Tuple[str, str]], distance_mode: str,
        step_feature: float, modes: Sequence[str], seq_norm: bool = True,
        max_x_across: int = 5, max_size_group: int = 30,
        seed: int = 0, on_device: bool = False,
        features_iter=None, file_order=None,
        device=None) -> Dict[str, float]:
    """Within / across ABX error rates.

    ``on_device`` computes the DTW costs on ``device`` (default: the card)
    by ``ops/dtw.py`` instead of the native host kernel.
    ``features_iter`` / ``file_order``: a stream of pre-extracted
    (file_id, features) pairs in any order, the segments assembled in
    ``file_order``, in place of ``feature_function`` per file: the
    batched path, which holds only item segments, never whole-file
    matrices."""
    if features_iter is not None:
        dataset = abx_it.ABXFeatureLoader.from_features_iter(
            path_item_file, file_order, features_iter, step_feature, True)
    else:
        dataset = abx_it.ABXFeatureLoader(path_item_file, seq_list,
                                          feature_function, step_feature,
                                          True)
    distance_function = abx_g.get_distance_function_from_name(distance_mode)
    scores: Dict[str, float] = {}
    for mode in ("within", "across"):
        if mode not in modes:
            continue
        print(f"Computing ABX {mode} speakers...")
        it = abx_it.ABXWithinGroupIterator(dataset, max_size_group,
                                           seed=seed) if mode == "within" \
            else abx_it.ABXAcrossGroupIterator(dataset, max_size_group,
                                               max_x=max_x_across,
                                               seed=seed)
        if len(it) == 0:
            print(f"WARNING: no valid {mode}-speaker triplet groups; "
                  f"skipped")
            continue
        coords, values, board = abx_g.get_abx_scores_dtw_on_group(
            it, distance_function, it.symmetric, on_device=on_device,
            device=device)
        scores[mode] = reduce_scores(coords, values, board,
                                     1 if mode == "within" else 2)
        print(f"...done. ABX {mode} : {scores[mode]}")
    return scores


def update_base_parser(parser):
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--feature_size", type=float, default=0.01)
    parser.add_argument("--cuda", action="store_true",
                        help="accepted for flag parity; the features run "
                             "on the card, the DTW where --on_device says")
    parser.add_argument("--mode", type=str, default="all",
                        choices=["all", "within", "across"])
    parser.add_argument("--max_size_group", type=int, default=10)
    parser.add_argument("--max_x_across", type=int, default=5)
    parser.add_argument("--out", type=str, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--on_device", action="store_true",
                        help="run the DTW on the card (plain PyTorch, one "
                             "anti-diagonal a step over a bucket of groups) "
                             "instead of the native host kernel")


def parse_args(argv):
    base_parser = argparse.ArgumentParser(description="ABX metric")
    subparsers = base_parser.add_subparsers(dest="load")
    p = subparsers.add_parser("from_checkpoint")
    update_base_parser(p)
    p.add_argument("path_checkpoint", type=str)
    p.add_argument("path_item_file", type=str)
    p.add_argument("path_dataset", type=str)
    p.add_argument("--seq_norm", action="store_true")
    p.add_argument("--max_size_seq", default=64000, type=int)
    p.add_argument("--strict", action="store_true")
    p.add_argument("--file_extension", type=str, default=".wav")
    p.add_argument("--get_encoded", action="store_true")
    p.add_argument("--batch_lanes", type=int, default=8,
                   help="extract features for N files at once (lane-packed "
                        "batches, feature_loader.build_features_batched); "
                        "1 restores the per-file extraction. Ignored with "
                        "--strict (per-file only).")
    p.add_argument("--compute_dtype", type=str, default=None,
                   choices=["float32", "bfloat16"],
                   help="override the checkpoint's activation dtype for "
                        "the extraction (features are float32 either "
                        "way). Default: the checkpoint's own.")

    p = subparsers.add_parser("from_pre_computed")
    update_base_parser(p)
    # as in the JAX package: the reference's from_pre_computed parser has
    # no path_item_file, yet its main reads one; it is taken here
    p.add_argument("path_item_file", type=str)
    p.add_argument("path_features", type=str)
    p.add_argument("--file_extension", type=str, default=".npy")
    return base_parser.parse_args(argv)


def main(argv=None, device=None) -> int:
    """Run the CLI on ``argv``; the model and ``--on_device``'s DTW on
    ``device`` (default: the card; raises without one)."""
    args = parse_args(argv if argv is not None else sys.argv[1:])
    feature_maker = None
    if args.load == "from_checkpoint":
        model, _, _ = load_model([args.path_checkpoint],
                                 compute_dtype=args.compute_dtype,
                                 device=device)
        # the hidden state carries across the chunks of a file
        feature_maker = FeatureModule(model, get_encoded=args.get_encoded,
                                      keep_hidden=True)

        def feature_function(x):
            return build_feature(feature_maker, x, strict=args.strict,
                                 max_size_seq=args.max_size_seq,
                                 seq_norm=args.seq_norm)
        path_dataset = args.path_dataset
        batch_lanes = 1 if args.strict else max(1, args.batch_lanes)
    elif args.load == "from_pre_computed":
        def feature_function(x):
            return np.load(x)
        path_dataset = args.path_features
        batch_lanes = 1
    else:
        print("usage: abx_cli {from_checkpoint,from_pre_computed} ...")
        return 2

    modes = ["within", "across"] if args.mode == "all" else [args.mode]
    step_feature = 1.0 / args.feature_size
    seq_list, _ = find_all_seqs(path_dataset, extension=args.file_extension)
    seq_list = [(os.path.splitext(os.path.basename(x))[0],
                 os.path.join(path_dataset, x)) for _, x in seq_list]
    if args.debug:
        seq_list = seq_list[:1000]

    features_iter = file_order = None
    if batch_lanes > 1:
        # only the files the item file names, as ABXFeatureLoader filters;
        # the generator streams into the loader, which keeps only the item
        # segments
        files_data, _, _, _ = abx_it.load_item_file(args.path_item_file)
        wanted = [(fid, p) for fid, p in seq_list if fid in files_data]
        print(f"Batched feature extraction: {len(wanted)} files, "
              f"{batch_lanes} lanes")
        file_order = [fid for fid, _ in wanted]
        features_iter = ((wanted[i][0], feats)
                         for i, feats in build_features_batched(
                             feature_maker, [p for _, p in wanted],
                             n_lanes=batch_lanes,
                             max_size_seq=args.max_size_seq,
                             seq_norm=args.seq_norm))

    scores = abx(feature_function, args.path_item_file, seq_list, "cosine",
                 step_feature, modes,
                 seq_norm=getattr(args, "seq_norm", False),
                 max_x_across=args.max_x_across,
                 max_size_group=args.max_size_group, seed=args.seed,
                 on_device=args.on_device, features_iter=features_iter,
                 file_order=file_order, device=device)

    default_out = os.path.dirname(args.path_checkpoint) \
        if args.load == "from_checkpoint" else args.path_features
    out_dir = args.out or default_out
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "ABX_scores.json"), "w") as f:
        json.dump(scores, f, indent=2)
    with open(os.path.join(out_dir, "ABX_args.json"), "w") as f:
        json.dump(vars(args), f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
