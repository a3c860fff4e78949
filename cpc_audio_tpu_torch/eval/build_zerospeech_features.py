"""Dump per-file CPC features for ZeroSpeech Track 1 submissions
(cpc_audio_tpu/eval/build_zerospeech_features.py).

Formats: ``fea`` (text, 10 ms timestamps), ``npz``, ``npy``; ``af`` needs
the optional ``arrayfire`` package and raises where it is missing.  The
model runs on the card (``main(argv, device="cpu")`` on the CPU);
lane-packed extraction where the chunking allows it, as in the JAX
package.

Usage:
    python -m cpc_audio_tpu_torch.eval.build_zerospeech_features DB OUT CKPT
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from ..data import find_all_seqs
from ..feature_loader import (FeatureModule, ModelPhoneCombined,
                              build_feature, build_features_batched,
                              load_model, load_supervised_criterion)


def build_all_feature(feature_maker, path_db: str, path_out: str, seq_list,
                      step_size: float = 0.01, strict: bool = False,
                      max_size_seq: int = 64000, fmt: str = "fea",
                      seq_norm: bool = False, batch_lanes: int = 1) -> None:
    start_step = step_size / 2
    # lane-packed where the chunking allows it: seq_norm implies strict
    # chunking (below), and ModelPhoneCombined stays per file
    if (batch_lanes > 1 and not (strict or seq_norm)
            and isinstance(feature_maker, FeatureModule)):
        paths = [os.path.join(path_db, p) for p in seq_list]
        for i, feature in build_features_batched(
                feature_maker, paths, n_lanes=batch_lanes,
                max_size_seq=max_size_seq):
            _write_feature(np.asarray(feature), seq_list[i], path_out,
                           fmt, step_size, start_step)
        return
    for seq_path in seq_list:
        feature = build_feature(feature_maker,
                                os.path.join(path_db, seq_path),
                                strict=strict or seq_norm,
                                max_size_seq=max_size_seq,
                                seq_norm=seq_norm)
        _write_feature(np.asarray(feature), seq_path, path_out, fmt,
                       step_size, start_step)


def _write_feature(feature: np.ndarray, seq_path: str, path_out: str,
                   fmt: str, step_size: float, start_step: float) -> None:
    _, n_steps, _ = feature.shape
    out_name = os.path.basename(os.path.splitext(seq_path)[0]) + f".{fmt}"
    fname = os.path.join(path_out, out_name)
    times = np.array([start_step + s * step_size
                      for s in range(n_steps)], np.float32)
    values = feature[0].astype(np.float32)
    if fmt == "npz":
        tot_time = np.array([step_size * n_steps], np.float32)
        with open(fname, "wb") as f:
            np.savez(f, time=times, features=values, totTime=tot_time)
    elif fmt == "npy":
        with open(fname, "wb") as f:
            np.save(f, values)
    elif fmt == "af":
        import arrayfire as af  # optional dependency, as in the reference
        tot_time = np.array([step_size * n_steps], np.float32)
        af.save_array("time", af.Array(times.tolist(),
                                       dtype=af.Dtype.f32), fname)
        af.save_array("totTime", af.interop.from_ndarray(tot_time),
                      fname, append=True)
        af.save_array("features", af.interop.from_ndarray(values),
                      fname, append=True)
    else:  # 'fea' text
        with open(fname, "w") as f:
            for step in range(n_steps):
                line = [start_step + step * step_size] \
                    + values[step].tolist()
                f.write(" ".join(str(x) for x in line) + "\n")


def main(argv=None, device=None) -> int:
    """Run the CLI on ``argv``, the model on ``device`` (default: the
    card; raises without one)."""
    parser = argparse.ArgumentParser(
        "Build features for zerospeech Track1 evaluation")
    parser.add_argument("pathDB")
    parser.add_argument("pathOut")
    parser.add_argument("pathCheckpoint")
    parser.add_argument("--extension", type=str, default=".wav")
    parser.add_argument("--addCriterion", action="store_true")
    parser.add_argument("--oneHot", action="store_true")
    parser.add_argument("--maxSizeSeq", default=64000, type=int)
    parser.add_argument("--train_mode", action="store_true")
    parser.add_argument("--format", default="fea", type=str,
                        choices=["npz", "fea", "npy", "af"])
    parser.add_argument("--strict", action="store_true")
    # taken for the reference CLI's sake and never read: the reference
    # parses these three and uses none of them (dead there too)
    for dead, kw in (("--dimReduction", {"type": str}),
                     ("--centroidLimits", {"type": int, "nargs": 2}),
                     ("--clusters", {"type": str})):
        parser.add_argument(dead, default=None, help="accepted for flag "
                            "parity; unused (dead in the reference too)",
                            **kw)
    parser.add_argument("--getEncoded", action="store_true")
    parser.add_argument("--seqNorm", action="store_true")
    parser.add_argument("--batch_lanes", type=int, default=8,
                        help="extract N files at once (lane-packed "
                             "batches); 1 restores per-file extraction. "
                             "Ignored with --strict / --seqNorm (strict "
                             "chunking is per file) and with "
                             "--addCriterion.")
    parser.add_argument("--compute_dtype", type=str, default=None,
                        choices=["float32", "bfloat16"],
                        help="override the checkpoint's activation dtype "
                             "(outputs stay float32). Default: the "
                             "checkpoint's own.")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    for dead in ("dimReduction", "centroidLimits", "clusters"):
        if getattr(args, dead) is not None:
            print(f"WARNING: --{dead} is accepted for reference-CLI parity "
                  f"but has no effect (the flag is dead in the reference "
                  f"too)")

    os.makedirs(args.pathOut, exist_ok=True)
    out = args.pathOut.rstrip(os.sep)
    with open(os.path.join(os.path.dirname(out),
                           f"{os.path.basename(out)}.json"), "w") as f:
        json.dump(vars(args), f, indent=2)

    out_data = [x[1] for x in find_all_seqs(args.pathDB,
                                            extension=args.extension,
                                            load_cache=False)[0]]
    model, _, _ = load_model([args.pathCheckpoint],
                             compute_dtype=args.compute_dtype,
                             device=device)
    step_size = 160 / 16000
    print(f"stepSize : {step_size}")
    feature_maker = FeatureModule(model, get_encoded=args.getEncoded)
    if args.addCriterion:
        criterion, _ = load_supervised_criterion(args.pathCheckpoint,
                                                 device=device)
        feature_maker = ModelPhoneCombined(feature_maker, criterion,
                                           args.oneHot)
    build_all_feature(feature_maker, args.pathDB, args.pathOut, out_data,
                      step_size=step_size, strict=args.strict,
                      max_size_seq=args.maxSizeSeq, fmt=args.format,
                      seq_norm=args.seqNorm, batch_lanes=args.batch_lanes)
    return 0


if __name__ == "__main__":
    sys.exit(main())
