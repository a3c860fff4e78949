"""The learning-quality gate of the port (cpc_audio_tpu/eval/learning_gate.py).

Trains CPC briefly on a small database with the port's trainer, then
runs the port's frozen phone linear-separability probe twice, on the
trained checkpoint and on a random-init model of the same architecture
(``--no_pretraining``), and asks that the trained features beat the
random ones by ``--margin`` in the probe's best validation accuracy
(``locAcc_val``).  The defaults are the JAX gate's: a 64-wide GRU AR
with linear heads, 5120-sample windows, batch 8, seed 1; its default
``--pathDB`` is the reference's fixture, which holds the two phone-labelled
files of ``PROBE_TRAIN`` / ``PROBE_VAL``.

Prints one JSON line with both accuracies and exits 0 iff trained -
random >= ``--margin``.

    python -m cpc_audio_tpu_torch.eval.learning_gate [--pathDB DB
        --pathPhone LABELS] [--nEpochCPC 40]

It runs on the card; from Python, ``main(argv, device="cpu")`` runs it on
the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

REF_DATA = "/root/reference/cpc/test_data"

# the two fixture sequences with phone labels (phone_labels.txt); CPC
# pre-training uses the whole database
PROBE_TRAIN = ["4051-11218-0044"]
PROBE_VAL = ["2911-12359-0007"]


def _best_val_acc(probe_dir: str) -> float:
    with open(os.path.join(probe_dir, "checkpoint_logs.json")) as f:
        logs = json.load(f)
    return max(float(v[0]) for v in logs["locAcc_val"])


def parse_args(argv):
    """The JAX gate's flags and defaults (learning_gate.py:49-92)."""
    p = argparse.ArgumentParser(description="CPC learning-quality gate")
    p.add_argument("--pathDB", default=os.path.join(REF_DATA, "test_db"))
    p.add_argument("--pathPhone",
                   default=os.path.join(REF_DATA, "phone_labels.txt"))
    p.add_argument("--workdir", default=None,
                   help="output root (default: fresh temp dir)")
    p.add_argument("--nEpochCPC", type=int, default=10)
    p.add_argument("--nEpochProbe", type=int, default=6)
    p.add_argument("--margin", type=float, default=0.02,
                   help="required (trained - random) val-accuracy margin")
    p.add_argument("--hiddenEncoder", type=int, default=64)
    p.add_argument("--hiddenGar", type=int, default=64)
    p.add_argument("--nPredicts", type=int, default=4)
    p.add_argument("--negativeSamplingExt", type=int, default=16)
    # 32-frame windows: batch 8 x 32 = 256 frames, a power of two, so the
    # default `auto` sampling resolves to the stratified objective
    p.add_argument("--sizeWindow", type=int, default=5120)
    p.add_argument("--rnnMode", default="linear")
    p.add_argument("--arMode", default="GRU")
    p.add_argument("--batchSizeGPU", type=int, default=8)
    p.add_argument("--random_seed", type=int, default=1)
    p.add_argument("--negativeSamplingMode", default="auto",
                   choices=["auto", "exact", "stratified", "rolled"])
    p.add_argument("--cpc_extra", nargs="*", default=[],
                   help="extra flags forwarded to the CPC trainer "
                        "(e.g. --cpc_extra --stopGradNegatives)")
    return p.parse_args(argv)


def main(argv=None, device=None) -> int:
    """Run the gate; ``device`` as ``_common.resolve_device`` (the card
    unless the caller asks for another)."""
    from .. import train
    from . import linear_separability

    args = parse_args(argv if argv is not None else sys.argv[1:])
    work = args.workdir or tempfile.mkdtemp(prefix="cpc_gate_")
    os.makedirs(work, exist_ok=True)
    train_list = os.path.join(work, "probe_train.txt")
    val_list = os.path.join(work, "probe_val.txt")
    with open(train_list, "w") as f:
        f.write("\n".join(PROBE_TRAIN) + "\n")
    with open(val_list, "w") as f:
        f.write("\n".join(PROBE_VAL) + "\n")

    ckpt_dir = os.path.join(work, "cpc")
    rc = train.main([
        "--nGPU", "1",
        "--pathDB", args.pathDB, "--pathCheckpoint", ckpt_dir,
        "--hiddenEncoder", str(args.hiddenEncoder),
        "--hiddenGar", str(args.hiddenGar),
        "--nPredicts", str(args.nPredicts),
        "--negativeSamplingExt", str(args.negativeSamplingExt),
        "--sizeWindow", str(args.sizeWindow),
        "--rnnMode", args.rnnMode, "--arMode", args.arMode,
        "--batchSizeGPU", str(args.batchSizeGPU),
        "--nEpoch", str(args.nEpochCPC),
        "--save_step", str(max(args.nEpochCPC - 1, 1)),
        "--random_seed", str(args.random_seed),
        "--negativeSamplingMode", args.negativeSamplingMode,
        "--n_process_loader", "2", "--ignore_cache"] + args.cpc_extra,
        device=device)
    if rc != 0:
        print(json.dumps({"gate": "learning", "ok": False,
                          "error": "cpc training failed"}))
        return 1
    ckpt = os.path.join(ckpt_dir, f"checkpoint_{args.nEpochCPC - 1}.pt")

    accs = {}
    for tag, extra in (("trained", []), ("random", ["--no_pretraining"])):
        out = os.path.join(work, f"probe_{tag}")
        rc = linear_separability.main(
            [args.pathDB, train_list, val_list, ckpt,
             "--pathPhone", args.pathPhone, "--pathCheckpoint", out,
             "--n_epoch", str(args.nEpochProbe), "--nGPU", "1",
             "--batchSizeGPU", "4", "--size_window", str(args.sizeWindow),
             "--random_seed", str(args.random_seed), "--ignore_cache"]
            + extra, device=device)
        if rc != 0:
            print(json.dumps({"gate": "learning", "ok": False,
                              "error": f"{tag} probe failed"}))
            return 1
        accs[tag] = _best_val_acc(out)

    delta = accs["trained"] - accs["random"]
    ok = delta >= args.margin
    print(json.dumps({"gate": "learning", "ok": bool(ok),
                      "acc_trained": round(accs["trained"], 5),
                      "acc_random": round(accs["random"], 5),
                      "delta": round(delta, 5),
                      "margin": args.margin,
                      "nEpochCPC": args.nEpochCPC,
                      "negativeSamplingMode": args.negativeSamplingMode,
                      "workdir": work}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
