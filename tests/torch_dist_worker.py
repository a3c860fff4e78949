"""One rank of the port's multi-rank CPU tests
(tests/test_torch_distributed.py, tests/test_torch_train.py); imports no
JAX.

Two uses:

* ``python torch_dist_worker.py steps DIR RANK WORLD``: join a gloo group
  of WORLD ranks through a file store in DIR and run the step scenarios
  whose inputs the test wrote to ``DIR/in.pt``, writing this rank's
  results to ``DIR/out_<rank>.pt``.
* ``CPC_TEST_RECORD_DIR=DIR python torch_dist_worker.py cli ARGV...``:
  run the train CLI on the CPU (``train.main(ARGV, device="cpu")``).
  ``--nGPU`` ranks are started by ``spawn``, which runs this file again as
  each child's main module, so the recorders below are installed in every
  rank: each rank writes ``DIR/cli_rank<r>.json`` with, per train and
  validation step, a digest of the global batch it loaded and of the rows
  it took, and the ranks that wrote a checkpoint.
"""

import copy
import hashlib
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from cpc_audio_tpu_torch import checkpoint as ckpt  # noqa: E402
from cpc_audio_tpu_torch import train  # noqa: E402
from cpc_audio_tpu_torch.config import TrainConfig  # noqa: E402
from cpc_audio_tpu_torch.criterion import build_criterion  # noqa: E402
from cpc_audio_tpu_torch.criterion import infonce  # noqa: E402
from cpc_audio_tpu_torch.models import build_model  # noqa: E402
from cpc_audio_tpu_torch.parallel import distributed  # noqa: E402
from cpc_audio_tpu_torch.parallel.train_step import (  # noqa: E402
    create_train_state, make_train_step)


def digest(x) -> str:
    a = np.ascontiguousarray(x.numpy() if torch.is_tensor(x) else x)
    return hashlib.sha256(a.tobytes()).hexdigest()[:16]


def params_digest(*modules) -> str:
    h = hashlib.sha256()
    for m in modules:
        for k, v in sorted(m.state_dict().items()):
            h.update(k.encode() + v.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


# ---- the CLI's recorders ----------------------------------------------------

_RECORD = {"steps": [], "saved_by": []}


def _rank_rows(x):
    rows = _ORIG_ROWS(x)
    if x is not None and x.ndim == 3:           # a batch, not its labels
        b, r = rows.shape[0], distributed.rank()
        _RECORD["steps"].append(
            {"global": digest(x), "rows": digest(rows),
             "half": digest(x[r * b:(r + 1) * b]),
             "n": int(x.shape[0]), "b": int(b)})
        _write_record()
    return rows


def _save_checkpoint(*args, **kwargs):
    _RECORD["saved_by"].append(distributed.rank())
    _write_record()
    return _ORIG_SAVE(*args, **kwargs)


def _write_record():
    with open(os.path.join(os.environ["CPC_TEST_RECORD_DIR"],
                           f"cli_rank{distributed.rank()}.json"), "w") as f:
        json.dump(_RECORD, f)


if os.environ.get("CPC_TEST_RECORD_DIR"):
    _ORIG_ROWS, distributed.rank_rows = distributed.rank_rows, _rank_rows
    _ORIG_SAVE, ckpt.save_checkpoint = ckpt.save_checkpoint, _save_checkpoint


# ---- the step scenarios -----------------------------------------------------

def _state(cfg, inputs, lr):
    """Model, criterion (heads' dropout off) and train state from the
    port's flat state dict in ``inputs``."""
    model, crit = build_model(cfg), build_criterion(cfg)
    sd = inputs["params"]
    model.load_state_dict({k[6:]: v for k, v in sd.items()
                           if k.startswith("model.")})
    crit.load_state_dict({k[10:]: v for k, v in sd.items()
                          if k.startswith("criterion.")})
    if hasattr(crit, "wPrediction"):
        crit.wPrediction.heads.dropout = 0.0
    return create_train_state(model, crit, "cpu", lr)


def _named(state):
    return {p: (prefix + n) for prefix, m in (("model.", state.model),
                                              ("criterion.", state.criterion))
            for n, p in m.named_parameters()}


def scenario_step(inputs, r, n):
    """CFG40's step on this rank's rows, twice: losses, accuracies, the
    summed gradients and the parameters after each step.  Under the global
    scope the exact sampler takes this rank's injected draws."""
    state = _state(inputs["cfg"], inputs, inputs["lr"])
    step = make_train_step(state, "cpu")
    x = distributed.rank_rows(inputs["x"])
    negatives = inputs["draws"][r] if "draws" in inputs else None
    out = []
    for _ in range(2):
        _, m = step(x, round_keys=inputs["round_keys"], negatives=negatives)
        out.append({"losses": m["losses"], "acc": m["acc"],
                    "grads": {name: p.grad.clone()
                              for p, name in _named(state).items()},
                    "params": {name: p.detach().clone()
                               for p, name in _named(state).items()},
                    "digest": params_digest(state.model, state.criterion)})
    return out


def scenario_pool(inputs, r, n):
    """Each sampler's value-weighted loss on the global pool: this rank's
    gradient, and the negatives of the value-coded batch."""
    out = {}
    z = distributed.rank_rows(inputs["z"])
    for name in ("exact", "stratified"):
        zl = z.clone().requires_grad_(True)
        pool = distributed.gather_rows(zl)
        if name == "exact":
            b, u = inputs["draws"][r]
            _, neg = infonce.sample_negatives(zl, inputs["W"], inputs["N"],
                                              b, u, pool=pool)
        else:
            _, neg = infonce.sample_negatives_stratified(
                zl, inputs["W"], inputs["N"], inputs["round_keys"],
                pool=pool)
        wgt = torch.arange(neg.numel(), dtype=torch.float32).reshape(
            neg.shape)
        (wgt * neg ** 2).sum().backward()
        coded = distributed.rank_rows(inputs["coded"])
        if name == "exact":
            _, negs = infonce.sample_negatives(
                coded, inputs["W"], inputs["N"], b, u,
                pool=distributed.gather_rows(coded))
        else:
            _, negs = infonce.sample_negatives_stratified(
                coded, inputs["W"], inputs["N"], inputs["round_keys"],
                pool=distributed.gather_rows(coded))
        out[name] = {"grad": zl.grad, "negatives": negs}
    return out


def scenario_batchnorm(inputs, r, n):
    """One step of the batchNorm config: the running statistics after the
    step, and those a step on this rank's rows alone would leave (its
    local batch moments), from a copy of the model."""
    state = _state(inputs["cfg"], inputs, inputs["lr"])
    x = distributed.rank_rows(inputs["x"])
    local = copy.deepcopy(state.model)
    with torch.no_grad():
        local(torch.from_numpy(x), train=True)
    make_train_step(state, "cpu")(x)
    return {"stats": dict(state.model.named_buffers()),
            "local": dict(local.named_buffers())}


def scenario_no_graph(inputs, r, n):
    """A step whose loss leaves parameters outside its graph: --cpc_mode
    none (no graph at all) and a frame probe on the encoding (--onEncoder:
    the AR outside).  Adam's step count on every parameter, and whether
    the parameters moved."""
    out = {}
    cfg = inputs["cfg"]
    x = distributed.rank_rows(inputs["x"])
    labels = distributed.rank_rows(inputs["labels"])
    for name, crit_of in (
            ("none", lambda: build_criterion(cfg.replace(cpc_mode="none"))),
            ("on_encoder", lambda: train.get_criterion(
                cfg.replace(onEncoder=True),
                TrainConfig(supervised=True, pathPhone="phones.txt"), 2,
                inputs["n_phones"], torch.Generator().manual_seed(0)))):
        model = build_model(cfg, torch.Generator().manual_seed(0))
        state = create_train_state(model, crit_of(), "cpu", 2e-3)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        _, m = make_train_step(state, "cpu")(
            x, labels=labels if name == "on_encoder" else None)
        counts = sorted({int(s["step"]) for s in
                         state.optimizer.state.values()})
        moved = {k: not torch.equal(v, before[k])
                 for k, v in model.state_dict().items()}
        out[name] = {"counts": counts, "moved": moved,
                     "losses": m["losses"],
                     "digest": params_digest(state.model, state.criterion)}
    return out


def scenario_rows(inputs, r, n):
    """This rank's rows of a numpy and a torch batch of n*3 rows, and the
    error a batch that does not split over the ranks raises."""
    try:
        distributed.rank_rows(np.zeros(n * 3 + 1))
        error = None
    except ValueError as e:
        error = str(e)
    return {"numpy": distributed.rank_rows(np.arange(n * 3)),
            "torch": distributed.rank_rows(torch.arange(n * 3)),
            "none": distributed.rank_rows(None), "error": error}


SCENARIOS = {"step": scenario_step, "step_global": scenario_step,
             "rows": scenario_rows, "pool": scenario_pool,
             "batchnorm": scenario_batchnorm, "no_graph": scenario_no_graph}


def steps(directory: str, r: int, n: int) -> None:
    torch.set_num_threads(1)
    distributed.init(r, n, "cpu", f"file://{directory}/store")
    try:
        inputs = torch.load(os.path.join(directory, "in.pt"),
                            weights_only=False)
        results = {name: SCENARIOS[name](inputs[name], r, n)
                   for name in inputs}
    finally:
        distributed.close()
    torch.save(results, os.path.join(directory, f"out_{r}.pt"))


if __name__ == "__main__":
    if sys.argv[1] == "steps":
        steps(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
    else:
        assert sys.argv[1] == "cli", sys.argv
        sys.exit(train.main(sys.argv[2:], device="cpu"))
