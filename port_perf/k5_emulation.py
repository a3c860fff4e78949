#!/usr/bin/env python3
"""K5's float32 forward on the card against its CPU emulations, element by
element.

Usage, from the root of a checkout, on a machine with one GPU:
    python3 port_perf/k5_emulation.py

For chip_smoke's K5 inputs (q, k, v ~ N(0, 1), the bias ~ N(0, 0.25)) at
the shapes of tests/test_torch_k5_split.py and at the train path's N 256,
S 128, dk 32, at dropout rate 0 and 0.1, runs the float32 forward kernel
(csrc/causal_attention_fwd.cu) on the card and, on the CPU from the same
inputs, the exact plain version in float64 and three emulations of the
kernel's arithmetic:

* ``split``: ``causal_attention.causal_attention_split``, the kernel's
  order: one float32 accumulator per output that takes, 16 columns
  (keys) at a time, the split products by increasing i + j
  (csrc/causal_attention.cuh ``rows_dot_rows``, ``acc_times_rows``), p .
  v added onto the rescaled output, the scores scaled by the float32
  reciprocal of sqrt(dk);
* ``whole``: each of the six split products over the whole depth apart,
  summed in float32 from the smallest, the scores divided by sqrt(dk)
  (``causal_attention_split`` before it took the kernel's order);
* ``kstep_rz``: the kernel's order with each m16n8k16 product (the
  accumulator plus 16 exact products) summed exactly and rounded toward
  zero to float32, a model of the tensor cores' float32 accumulation.

Prints, for each case, each one's largest |error| against float64, the
largest |card - emulation| and the share of the card's outputs each
emulation gives bit for bit, then one JSON line of the same numbers.
"""

from __future__ import annotations

import json
import math
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

CASES = ((8, 16, 32), (8, 60, 32), (8, 128, 32), (8, 128, 64),
         (8, 100, 128), (256, 128, 32))
K_STEP = 16          # the depth of one mma.sync.m16n8k16


def rz32(x: torch.Tensor) -> torch.Tensor:
    """float64 -> float32 rounded toward zero."""
    y = x.float()
    over = y.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)


def mma_chain_rz(a_planes, b_planes, init, descending: bool):
    """``causal_attention.kstep_products`` with each K_STEP product and
    the accumulator summed exactly, then rounded toward zero."""
    n = len(a_planes)
    acc = init.double()
    for k0 in range(0, a_planes[0].shape[-1], K_STEP):
        for d in range(n):
            for i in (range(d, -1, -1) if descending else range(d + 1)):
                a = a_planes[i][..., k0:k0 + K_STEP].double()
                b = b_planes[d - i][..., k0:k0 + K_STEP, :].double()
                acc = rz32(acc + a @ b).double()
    return acc.float()


def forward(q, k, v, bias, rate, seed, products):
    """The forward's tiles and softmax (``causal_attention_split``) with
    ``products`` = (the planes' products ``f(a_planes, b_planes, acc,
    descending)``, the scores' scale ``g(s)``)."""
    from cpc_audio_tpu_torch.ops import causal_attention as ca
    from cpc_audio_tpu_torch.ops import dropout, ffn
    N, S, dk = q.shape
    P = ca.FWD_PLANES
    kt = [t.transpose(-1, -2) for t in ffn.split_planes(k, P)]
    s = products[0](ffn.split_planes(q, P), kt, torch.zeros(N, S, S), False)
    s = products[1](s + bias)
    causal = torch.ones(S, S, dtype=torch.bool).tril()
    s = s.masked_fill(~causal, float("-inf"))
    mask = dropout.ar_attention_mask(seed, rate, 0, N, S, q.device)
    vp = ffn.split_planes(v, P)
    tile = ca.key_tile(dk, P)
    m = torch.full((N, S, 1), float("-inf"))
    l = torch.zeros(N, S, 1)
    o = torch.zeros(N, S, dk)
    for k0 in range(0, S, tile):
        st = s[..., k0:k0 + tile]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        rescale = torch.exp(m - m_new)
        e = torch.exp(st - m_new)
        pd = e if mask is None else e * mask[..., k0:k0 + tile]
        l = l * rescale + e.sum(-1, keepdim=True)
        o = products[0](ffn.split_planes(pd, P),
                        [t[:, k0:k0 + tile] for t in vp], o * rescale, True)
        m = m_new
    return o * (1.0 / l)


def whole(a_planes, b_planes, acc, descending):
    """Each split product over the whole depth apart, summed from the
    smallest (``ffn.SPLIT_PAIRS``), then added to ``acc``."""
    from cpc_audio_tpu_torch.ops import ffn
    out = None
    for i, j in ffn.SPLIT_PAIRS[6]:
        term = a_planes[i] @ b_planes[j]
        out = term if out is None else out + term
    return acc + out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script runs the kernel")
    from cpc_audio_tpu_torch import _common
    from cpc_audio_tpu_torch.ops import causal_attention as ca
    _common.precision_policy()
    dev = torch.device("cuda", 0)
    rows = []
    for N, S, dk in CASES:
        rng = np.random.RandomState(N + S + dk)
        q, k, v = (torch.from_numpy(rng.randn(N, S, dk).astype(np.float32))
                   for _ in range(3))
        bias = torch.from_numpy((rng.randn(N, S, S) * 0.5)
                                .astype(np.float32))
        for rate in (0.0, 0.1):
            seed = torch.tensor([3], dtype=torch.int64)
            card = ca.causal_attention_fwd(
                *(t.to(dev) for t in (q, k, v, bias)), rate,
                seed.to(dev)).cpu()
            exact = ca.causal_attention_ref(
                *(t.double() for t in (q, k, v, bias)), rate, seed)
            dk_inv = torch.tensor(1.0) / torch.sqrt(torch.tensor(float(dk)))
            emul = {"split": ca.causal_attention_split(q, k, v, bias, rate,
                                                       seed),
                    "whole": forward(q, k, v, bias, rate, seed, (
                        whole, lambda x: x / math.sqrt(dk))),
                    "kstep_rz": forward(q, k, v, bias, rate, seed, (
                        mma_chain_rz, lambda x: x * dk_inv))}
            row = {"N": N, "S": S, "dk": dk, "rate": rate,
                   "card_err": (card.double() - exact).abs().max().item()}
            for name, e in emul.items():
                row[f"{name}_err"] = (e.double() - exact).abs().max().item()
                row[f"card_vs_{name}"] = (card - e).abs().max().item()
                row[f"{name}_bits"] = (card == e).float().mean().item()
            rows.append(row)
            print(f"N {N} S {S} dk {dk} rate {rate:g}: max |err| vs float64 "
                  f"card {row['card_err']:.3e}; " + "; ".join(
                      f"{n} {row[f'{n}_err']:.3e} (card - {n} "
                      f"{row[f'card_vs_{n}']:.3e}, bit-equal "
                      f"{row[f'{n}_bits']:.1%})" for n in emul), flush=True)
    card_line = os.popen("nvidia-smi --query-gpu=name,power.limit "
                         "--format=csv,noheader").read().strip()
    print(card_line)
    print(json.dumps({"k5_emulation": rows}))


if __name__ == "__main__":
    main()
