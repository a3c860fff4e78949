#!/usr/bin/env python3
"""Why K3's float32 body takes G1 as 6 split products, in both directions:
its arithmetic, written plainly (ops/ffn.py `layer_tail_bwd_split`,
`layer_tail_fwd_split`), on the CPU.

Usage, from the root of a checkout (no GPU needed; under a minute):
    python3 port_perf/k3_split_accuracy.py

For one head of the default train shape (M 3712, D 256, F 2048) and of
the long-window one (M 1952, D 512), inputs drawn from a numpy seed as
chip_smoke.py draws them (x ~ N(0, 1), W1 ~ N(0, 1/D), W2 ~ N(0, 1/F),
dout ~ N(0, 0.01)), prints each gradient's 2-norm error relative to the
exact (float64) plain backward, for the float32 plain backward and for
the split arithmetic with G1 (y W1, whose sign makes the ReLU live mask)
at 3 and at 6 products, and how many live units differ from the exact
mask.  Then, for the float32 train-shape inputs of tests/test_torch_cuda.py
(K 2, numpy seed M + D + F), the hidden units whose exact pre-activation
lies within 1e-6 of the ReLU kink, with the float32 and the split
arithmetic's values of it, and, at rates 0 and 0.1, the kept units the
card test leaves undecided: exact pre-activation within KINK_C 2^-24
(sum_d |y_d W1_df| + |b1_f|) of 0.  Last, for every float32 input of
tests/test_torch_cuda.py's K3 tests, the forward's worst error against the
float32 plain version as a share of those tests' tolerance (2e-5 + 2e-5
|want|), with G1 of 3 and of 6 split products (G2 of 3).  These are CPU
numbers of the arithmetic, not of the card.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from cpc_audio_tpu_torch.ops import ffn  # noqa: E402

NAMES = ("dx", "dln1w", "dln1b", "dw1", "db1", "dw2", "db2", "dln2w",
         "dln2b")


def inputs(M: int, D: int, F: int, seed: int):
    rng = np.random.RandomState(seed)

    def r(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy((rng.randn(*shape) * scale + shift)
                                .astype(np.float32))
    args = (r(1, M, D), r(1, D, scale=0.1, shift=1.0), r(1, D, scale=0.1),
            r(1, D, F, scale=D ** -0.5), r(1, F, scale=0.1),
            r(1, F, D, scale=F ** -0.5), r(1, D, scale=0.1),
            r(1, D, scale=0.1, shift=1.0), r(1, D, scale=0.1))
    return args, r(1, M, D, scale=0.1)


# tests/test_torch_cuda.py's rule for the units no float32 version decides
KINK_C = 1.0
# its float32 tolerance, atol and rtol, and its K3 tests' float32 inputs:
# (M, D, F, numpy seed, rates) of test_layer_tail_kernel (seed M + D, rate
# 0) and of test_layer_tail_bwd_kernel (seed M + D + F, rates 0 and 0.1)
TOL_F32 = 2e-5
FWD_CASES = [(M, D, F, M + D, (0.0,)) for M, D, F in (
    (40, 64, 128), (64, 256, 256), (33, 32, 64), (70, 512, 2048),
    (40, 384, 2048), (21, 1024, 2048), (29, 768, 2048))] + [
    (M, D, F, M + D + F, (0.0, 0.1)) for M, D, F in (
        (40, 64, 128), (33, 32, 64), (70, 256, 256), (45, 512, 2048),
        (45, 384, 2048), (37, 1024, 2048), (29, 768, 2048), (33, 96, 96),
        (3712, 256, 2048), (1952, 512, 2048))]


def card_test_inputs(M: int, D: int, F: int, K: int = 2, seed=None):
    """tests/test_torch_cuda.py's float32 K3 inputs (``_tail_args``)."""
    rng = np.random.RandomState(M + D + F if seed is None else seed)

    def r(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy((rng.randn(*shape) * scale + shift)
                                .astype(np.float32))
    return (r(K, M, D), r(K, D, scale=0.1, shift=1.0), r(K, D, scale=0.1),
            r(K, D, F, scale=D ** -0.5), r(K, F, scale=0.1),
            r(K, F, D, scale=F ** -0.5), r(K, D, scale=0.1),
            r(K, D, scale=0.1, shift=1.0), r(K, D, scale=0.1))


def pre_activation(args, products=None):
    """LN1(x) W1 + b1: exact (float64), float32, or split products."""
    x, ln1w, ln1b, w1, b1 = args[:5]
    if products is None:
        x, ln1w, ln1b, w1, b1 = (t.double() for t in (x, ln1w, ln1b, w1,
                                                      b1))
    y = ffn._affine(ffn._ln(x, 1e-5)[0], ln1w, ln1b)
    pre = (y @ w1 if products in (None, 1) else
           ffn.split_matmul(y, w1, products))
    return pre + b1[:, None]


def live(args, products=None):
    """The live mask (pre-activation > 0): exact, float32 or split."""
    return pre_activation(args, products) > 0


def main() -> None:
    for M, D, F in ((3712, 256, 2048), (1952, 512, 2048)):
        args, dout = inputs(M, D, F, seed=M + D)
        exact = ffn.layer_tail_bwd_ref(*[a.double() for a in args],
                                       dout.double())
        mask = live(args)
        runs = (("float32 plain", ffn.layer_tail_bwd_ref(*args, dout), 1),
                ("split, G1 of 3", ffn.layer_tail_bwd_split(
                    *args, dout, g1_products=3), 3),
                ("split, G1 of 6", ffn.layer_tail_bwd_split(
                    *args, dout, g1_products=6), 6))
        for label, got, products in runs:
            flips = int((live(args, products) != mask).sum())
            errs = ", ".join(
                f"{n} {((g.double() - w).norm() / w.norm()).item():.2e}"
                for n, g, w in zip(NAMES, got, exact))
            print(f"M {M} / D {D} / F {F}, {label}: {flips} of {M * F} "
                  f"units' live bits differ from the exact mask; 2-norm "
                  f"error / exact norm: {errs}", flush=True)
    for M, D, F in ((3712, 256, 2048), (1952, 512, 2048)):
        args = card_test_inputs(M, D, F)
        exact, f32, split = (pre_activation(args, p) for p in (None, 1, 6))
        near = (exact.abs() < 1e-6).nonzero().tolist()
        print(f"card test inputs, K 2 / M {M} / D {D} / F {F}: {len(near)} "
              f"units within 1e-6 of the kink" + "".join(
                  f"; (head {k}, row {m}, unit {f}) exact "
                  f"{exact[k, m, f].item():.3e}, float32 "
                  f"{f32[k, m, f].item():.3e}, split of 6 "
                  f"{split[k, m, f].item():.3e}" for k, m, f in near),
              flush=True)
        x, ln1w, ln1b, w1, b1 = (t.double() for t in args[:5])
        y = ffn._affine(ffn._ln(x, 1e-5)[0], ln1w, ln1b)
        ratio = exact.abs() / (2.0 ** -24 * (y.abs() @ w1.abs()
                                              + b1.abs()[:, None]))
        for rate in (0.0, 0.1):
            mask = ffn.dropout.ffn_mask(torch.tensor([12345]), rate, 2, M, F,
                                        "cpu")
            kept = ratio if mask is None else torch.where(
                mask > 0, ratio, torch.full_like(ratio, np.inf))
            near = (kept <= KINK_C).nonzero().tolist()
            print(f"  rate {rate}: {len(near)} kept units undecided (within "
                  f"KINK_C = {KINK_C:g} of 2^-24 sum |y W1| + |b1| of 0): "
                  + ", ".join(f"(head {k}, row {m}, unit {f}) at "
                              f"{kept[k, m, f].item():.3f}"
                              for k, m, f in near), flush=True)
    worst = {3: [], 6: []}
    for M, D, F, seed, rates in FWD_CASES:
        args = card_test_inputs(M, D, F, seed=seed)
        for rate in rates:
            s = torch.tensor([12345])
            want = ffn.layer_tail_ref(*args, 1e-5, rate, s)
            for g1 in worst:
                got = ffn.layer_tail_fwd_split(*args, 1e-5, rate, s, g1)
                worst[g1].append(((got - want).abs() / (
                    TOL_F32 + TOL_F32 * want.abs())).max().item())
    for g1, shares in worst.items():
        print(f"float32 forward, G1 of {g1} and G2 of 3 split products, "
              f"over the {len(shares)} float32 card cases: worst error "
              f"{min(shares):.3f}-{max(shares):.3f} of the tolerance",
              flush=True)


if __name__ == "__main__":
    main()
