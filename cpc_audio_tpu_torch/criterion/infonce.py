"""InfoNCE (CPC) criterion (cpc_audio_tpu/criterion/infonce.py).

Ported: ``stack_positives``, the ``auto`` -> stratified resolution
(``_stratified_shapes_ok``), the stratified scorer
(``_stratified_score_pair``: a permutation gather plus block-batched
``bmm`` forward; two block-batched ``bmm`` and an inverse-permutation
gather backward, as a ``torch.autograd.Function``) and the
``_info_nce_reduce`` with its padded-row mask.  The Feistel round keys
come from a ``torch.Generator`` or are passed in (``round_keys``, which
the train step derives on the device), so a test can give both packages
the same keys; JAX's threefry stream itself is not reproduced.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .._common import fused_layer_switches
from ..config import CPCConfig
from ..ops.feistel import ROUNDS, feistel_inverse, feistel_permute
from .prediction import PredictionNetwork


def stack_positives(encoded: torch.Tensor, n_predicts: int,
                    window_size: int) -> torch.Tensor:
    """pos[k] = z[:, k+1 : k+1+W] -> (K, B, W, C)  (infonce.py:422)."""
    return torch.stack([encoded[:, k + 1:k + 1 + window_size]
                        for k in range(n_predicts)])


def stratified_shapes_ok(Bp: int, S: int, n_negative: int, B: int,
                         window_size: int) -> bool:
    """The stratified sampler's domain: power-of-two batch*seq and
    negatives, N <= M, anchors fit in M (infonce.py:214)."""
    M, N = Bp * S, n_negative
    return (M & (M - 1) == 0 and N & (N - 1) == 0 and N <= M
            and B * window_size <= M)


def _pad_rows(preds: torch.Tensor, M: int) -> torch.Tensor:
    """(K, B, W, C) -> (K, M, C): anchor rows past B*W are zeros."""
    K, B, W, C = preds.shape
    pf = preds.new_zeros((K, M, C))
    pf[:, :B * W] = preds.reshape(K, B * W, C)
    return pf


class _StratifiedScores(torch.autograd.Function):
    """``_stratified_score_pair`` (infonce.py:275-334): positive scores
    (K, M) and block negative scores (K, M, Q); scatter-free in both
    directions."""

    @staticmethod
    def forward(ctx, preds, pos, z_flat, perm, inv, gblk, inv_c):
        K, B, W, C = preds.shape
        M = perm.shape[0]
        Q = M // gblk
        zp = z_flat[perm]                                       # (M, C)
        ps = torch.zeros((K, M), dtype=torch.float32, device=preds.device)
        ps[:, :B * W] = (preds.float() * pos.float()).sum(-1).reshape(K, -1)
        # ns[k, q, g, p] = pf[k, q, g] . zp[p, g]: one (K*Q, C) x (C, Q)
        # product per residue g, float32 as the JAX einsums' accumulation.
        a = _pad_rows(preds, M).float().reshape(K, Q, gblk, C) \
            .permute(2, 0, 1, 3).reshape(gblk, K * Q, C)
        bmat = zp.float().reshape(Q, gblk, C).permute(1, 2, 0)  # (g, C, Q)
        ns = torch.bmm(a, bmat).reshape(gblk, K, Q, Q).permute(1, 2, 0, 3)
        ctx.save_for_backward(preds, pos, zp, inv)
        ctx.args = (gblk, inv_c)
        return ps * inv_c, ns.reshape(K, M, Q) * inv_c

    @staticmethod
    def backward(ctx, dps, dns):
        preds, pos, zp, inv = ctx.saved_tensors
        gblk, inv_c = ctx.args
        K, B, W, C = preds.shape
        M = zp.shape[0]
        Q = M // gblk
        BW = B * W
        dt = preds.dtype
        # the f32 score cotangents go to the compute dtype once
        dps_c = (dps[:, :BW].reshape(K, B, W) * inv_c).to(dt)[..., None]
        dns_c = (dns * inv_c).to(dt).reshape(K, Q, gblk, Q)
        # dpn[k, q, g] = sum_p dns[k, q, g, p] zp[p, g]
        a = dns_c.permute(2, 0, 1, 3).reshape(gblk, K * Q, Q)
        dpn = torch.bmm(a, zp.reshape(Q, gblk, C).transpose(0, 1))
        dpn = dpn.reshape(gblk, K, Q, C).permute(1, 2, 0, 3).reshape(K, M, C)
        dpred = dps_c * pos + dpn[:, :BW].reshape(K, B, W, C)
        dpos = dps_c * preds
        # dzp[p, g] = sum_{k, q} dns[k, q, g, p] pf[k, q, g]
        a2 = dns_c.permute(2, 3, 0, 1).reshape(gblk, Q, K * Q)
        b2 = _pad_rows(preds, M).reshape(K, Q, gblk, C) \
            .permute(2, 0, 1, 3).reshape(gblk, K * Q, C)
        dzp = torch.bmm(a2, b2).transpose(0, 1).reshape(M, C)
        # zp = z_flat[perm]  =>  dz_flat[j] = dzp[inv[j]]: a gather
        return dpred, dpos, dzp.to(dt)[inv], None, None, None, None


def stratified_scores(preds: torch.Tensor, pos: torch.Tensor,
                      z_flat: torch.Tensor, perm: torch.Tensor,
                      inv: torch.Tensor, gblk: int,
                      inv_c: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Positive scores (K, M) and block negative scores (K, M, Q) of the
    stratified sampler (infonce.py:245-272); anchor rows past B*W are zero
    padding.  ``inv`` is the inverse of ``perm``, for the backward."""
    return _StratifiedScores.apply(preds, pos, z_flat, perm, inv, gblk,
                                   inv_c)


def info_nce_reduce(pos_score: torch.Tensor, neg_score: torch.Tensor,
                    n_valid: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-step CE (positive = class 0) and argmax accuracy over flat
    anchor rows; rows past ``n_valid`` are masked (infonce.py:393-419)."""
    mx = neg_score.max(dim=2).values                            # (K, R)
    m = torch.maximum(mx, pos_score)
    lse = m + torch.log(torch.exp(neg_score - m[..., None]).sum(dim=2)
                        + torch.exp(pos_score - m))
    ce = pos_score - lse
    correct = (pos_score >= mx).float()        # ties go to the positive
    R = pos_score.shape[1]
    if R != n_valid:
        mask = (torch.arange(R, device=pos_score.device) < n_valid).float()
        ce = ce * mask
        correct = correct * mask
    return -ce.sum(dim=1) / n_valid, correct.sum(dim=1) / n_valid


class CPCUnsupervisedCriterion(nn.Module):
    """K-step InfoNCE with within-batch negatives (infonce.py:449).

    ``forward(c, z, label, train=False, generator=None, round_keys=None,
    seed=None) -> (losses (K,), acc (K,))``; ``train=True`` runs the
    heads' dropout and needs ``seed`` (ops/dropout.py)."""

    def __init__(self, n_predicts: int, dim_output_ar: int,
                 dim_output_encoder: int, negative_sampling_ext: int,
                 size_input_seq: int = 128, sampling_mode: str = "auto",
                 rnn_mode: str = "transformer",
                 generator: Optional[torch.Generator] = None,
                 dropout: bool = False, attention_block: bool = False):
        super().__init__()
        if sampling_mode not in ("auto", "stratified"):
            raise NotImplementedError(
                f"negativeSamplingMode={sampling_mode!r} is not ported yet: "
                f"ROADMAP Queue 1 item 5 (exact) / item 11 (rolled)")
        if dim_output_ar != dim_output_encoder:
            raise ValueError("transformer heads need hiddenGar == "
                             "hiddenEncoder")
        self.n_predicts = n_predicts
        self.dim_output_encoder = dim_output_encoder
        self.negative_sampling_ext = negative_sampling_ext
        self.wPrediction = PredictionNetwork(
            n_predicts, dim_output_encoder, rnn_mode,
            size_input_seq - n_predicts, generator, dropout,
            attention_block)

    def forward(self, c_feature: torch.Tensor, encoded: torch.Tensor,
                label=None, train: bool = False,
                generator: Optional[torch.Generator] = None,
                round_keys: Optional[torch.Tensor] = None,
                seed: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        B, S, _ = c_feature.shape
        K = self.n_predicts
        W = S - K
        N = self.negative_sampling_ext
        if not stratified_shapes_ok(B, S, N, B, W):
            raise NotImplementedError(
                f"batch {B} x {S} frames with {N} negatives needs the exact "
                f"sampler, which is not ported yet: ROADMAP Queue 1 item 5")
        pos = stack_positives(encoded, K, W)                 # (K, B, W, C)
        preds = self.wPrediction(c_feature[:, :W], train, seed)  # (K,B,W,C)
        M = B * S
        if round_keys is None:
            round_keys = torch.randint(0, 2 ** 32, (ROUNDS,),
                                       generator=generator,
                                       dtype=torch.int64)
        ar = torch.arange(M, device=encoded.device)
        nbits = M.bit_length() - 1
        perm = feistel_permute(ar, round_keys, nbits)
        inv = feistel_inverse(ar, round_keys, nbits)
        C = self.dim_output_encoder
        pos_score, neg_score = stratified_scores(
            preds, pos, encoded.reshape(M, -1), perm, inv, M // N, 1.0 / C)
        return info_nce_reduce(pos_score, neg_score, B * W)


def build_criterion(config: CPCConfig,
                    generator: Optional[torch.Generator] = None
                    ) -> CPCUnsupervisedCriterion:
    """The CPC criterion for ``config`` (cpc_audio_tpu/train.py:37-58); its
    heads run the whole-block kernel under ``CPC_ATTN_BLOCK=1``."""
    if (config.cpc_mode is not None or config.speakerEmbedding
            or config.stopGradNegatives):
        raise NotImplementedError(
            "cpc_mode / speakerEmbedding / stopGradNegatives are not ported "
            "yet: ROADMAP Queue 1 item 11 (non-default variants)")
    return CPCUnsupervisedCriterion(
        n_predicts=config.nPredicts,
        dim_output_ar=config.hiddenGar,
        dim_output_encoder=config.hiddenEncoder,
        negative_sampling_ext=config.negativeSamplingExt,
        size_input_seq=config.sizeWindow // 160,
        sampling_mode=config.negativeSamplingMode,
        rnn_mode=config.rnnMode,
        generator=generator,
        dropout=config.dropout,
        attention_block=fused_layer_switches()[1])
