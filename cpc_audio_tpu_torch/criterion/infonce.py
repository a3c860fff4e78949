"""InfoNCE (CPC) criterion (cpc_audio_tpu/criterion/infonce.py).

Ported: ``stack_positives``; the samplers ``sample_negatives`` (exact,
the reference's iid scheme), ``sample_negatives_rolled`` and the
materialised ``sample_negatives_stratified``; the fused stratified scorer
(``_stratified_score_pair``) and ``_score_pair``, each a
``torch.autograd.Function`` whose backward casts the float32 score
cotangents to the compute dtype once; ``_info_nce_reduce`` with its
padded-row mask; and the mode x scope x stop-grad resolution of
``CPCUnsupervisedCriterion.__call__`` (infonce.py:549-593).

The exact and rolled negatives are one row gather of the flat (Bp*S, C)
pool; its backward is the row scatter-add K8 (``ops/scatter_add.py``).
The materialised stratified gather's backward is a block-gather
correlation and an inverse-permutation gather, with no scatter.

Random draws: the Feistel round keys and the exact/rolled samplers'
indices come from a ``torch.Generator`` or are derived on the device by
the train step (``round_keys``, ``neg_seed``: ``ops/dropout.py``), or are
passed in (``negatives``), so a test can give both packages the same
draws; JAX's threefry stream itself is not reproduced.

``negative_sampling_scope="global"`` draws negatives from the batch of
every rank (infonce.py:521-529): the pool is the (world*B, S, C)
concatenation of every rank's encoding in rank order
(``parallel/distributed.gather_rows``, differentiable: its backward sums
the pool's cotangent over ranks, ``psum_scatter``), so the exact
sampler's batch indices run over world*B rows and K8 scatters into
world*B*S.  On one device the pool is the local batch, as JAX's
``all_gather`` over one device.  With a pool set ``auto`` resolves to
``exact`` and ``stratified`` takes the materialised sampler, as in JAX.

``mode="reverse"`` (``--cpc_mode reverse``) flips c and z in time before
anything else (infonce.py:498-500); ``speaker_embedding`` E > 0 adds a
``speakerEmb`` table of n_speakers x E, whose row for each window's
speaker is broadcast over the anchors and concatenated to c, so the heads
read hiddenGar + E channels (infonce.py:485-489, :532-536).
``--cpc_mode none`` builds :class:`NoneCriterion`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .._common import fused_layer_switches
from ..config import CPCConfig
from ..models.encoder import encoding_dtype
from ..ops import dropout, ffn, head_attention, lstm, scatter_add
from ..ops.feistel import ROUNDS, feistel_inverse, feistel_permute
from ..ops.scatter_add import scatter_add_rows
from ..parallel.distributed import gather_rows
from .prediction import PredictionNetwork

SAMPLING_MODES = ("auto", "exact", "rolled", "stratified")
SCOPES = ("device", "global")


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


def stratified_domain_check(Bp: int, S: int, n_negative: int, B: int,
                            window_size: int) -> Tuple[int, int, int]:
    """(M, g, nbits) of the stratified sampler; raises on a shape outside
    its domain, as ``_stratified_domain_check`` (infonce.py:224-242)."""
    M, N = Bp * S, n_negative
    if M & (M - 1):
        raise ValueError(
            f"stratified sampling needs a power-of-two batch*seq frame "
            f"count, got {Bp}x{S}={M}; use negativeSamplingMode=exact")
    if N & (N - 1) or N > M:
        raise ValueError(
            f"stratified sampling needs a power-of-two negativeSamplingExt"
            f" <= batch*seq ({M}), got {N}; use negativeSamplingMode=exact")
    if B * window_size > M:
        raise ValueError("anchor slots exceed the sampling domain")
    return M, M // N, M.bit_length() - 1


# ---- samplers ---------------------------------------------------------------

class _PoolGather(torch.autograd.Function):
    """rows = pool_flat[idx]; the backward scatter-adds the rows'
    cotangents into the pool's rows: K8 on the card."""

    @staticmethod
    def forward(ctx, pool_flat, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = pool_flat.shape[0]
        return pool_flat.index_select(0, idx)

    @staticmethod
    def backward(ctx, drows):
        idx, = ctx.saved_tensors
        dpool = scatter_add_rows(drows.contiguous(), idx, ctx.n_rows)
        return dpool.to(drows.dtype), None


def _gather_negatives(pool: torch.Tensor, flat_idx: torch.Tensor,
                      B: int, W: int, N: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(flat_idx (B*W, N), negatives (B, W, N, C)) of pool rows
    ``flat_idx``, laid out (b, w, n)."""
    Bp, S, C = pool.shape
    flat_idx = flat_idx.reshape(B * W, N)
    neg = _PoolGather.apply(pool.reshape(Bp * S, C), flat_idx.reshape(-1))
    return flat_idx, neg.reshape(B, W, N, C)


def sample_negatives(encoded: torch.Tensor, window_size: int,
                     n_negative: int, batch_idx: torch.Tensor,
                     seq_off: torch.Tensor,
                     pool: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Within-batch iid negatives, the reference's exact scheme
    (infonce.py:93-122): neg[b, w, n] = pool[b', (w + u) % S] with
    b' = batch_idx[b, n, w] in [0, Bp) and u = seq_off[b, n, w] in [1, S).
    ``pool`` (Bp, S, C) defaults to ``encoded``.  Returns the flat pool
    index (B*W, N) and the negatives (B, W, N, C)."""
    B = encoded.shape[0]
    if pool is None:
        pool = encoded
    S = pool.shape[1]
    base = torch.arange(window_size, device=pool.device)
    seq_idx = (seq_off + base) % S                            # (B, N, W)
    flat_idx = (batch_idx * S + seq_idx).transpose(1, 2)      # (B, W, N)
    return _gather_negatives(pool, flat_idx, B, window_size, n_negative)


def sample_negatives_rolled(encoded: torch.Tensor, window_size: int,
                            n_negative: int, batch_idx: torch.Tensor,
                            seq_off: torch.Tensor,
                            pool: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One (row, offset) pair per (b, n) (infonce.py:125-154, a deprecated
    test hook there): neg[b, w, n] = pool[b', (u + w) % S] with
    b' = batch_idx[b, n], u = seq_off[b, n].  The same gather as
    :func:`sample_negatives`; returns (flat index (B*W, N), negatives)."""
    B = encoded.shape[0]
    if pool is None:
        pool = encoded
    S = pool.shape[1]
    base = torch.arange(window_size, device=pool.device)
    flat_idx = batch_idx[:, None, :] * S \
        + (seq_off[:, None, :] + base[None, :, None]) % S     # (B, W, N)
    return _gather_negatives(pool, flat_idx, B, window_size, n_negative)


class _WindowedPermutationGather(torch.autograd.Function):
    """neg[b, w, n] = z_flat[idx[b*W + w, n]] with idx[s, n] =
    pi((s + g*n) mod M) (``_windowed_permutation_gather``,
    infonce.py:157-211).  Backward: with u = pi^-1(d),
    dz[d] = sum_n dneg[(u - g*n) mod M, n], a cyclic correlation of
    contiguous (g*C) blocks, then one inverse-permutation gather."""

    @staticmethod
    def forward(ctx, z_flat, idx, inv, B, W, N):
        ctx.save_for_backward(inv)
        ctx.shape = (B, W, N)
        return z_flat.index_select(0, idx.reshape(-1)).reshape(
            B, W, N, z_flat.shape[-1])

    @staticmethod
    def backward(ctx, dneg):
        inv, = ctx.saved_tensors
        B, W, N = ctx.shape
        C = dneg.shape[-1]
        M = inv.shape[0]
        BW = B * W
        g = M // N
        Q = M // g                                             # == N
        d = dneg.reshape(BW, N, C).transpose(0, 1)             # (N, BW, C)
        d = torch.cat([d, d.new_zeros((N, M - BW, C))], dim=1)
        dq = d.reshape(N, Q, g * C)
        ar_q = torch.arange(Q, device=dneg.device)
        ar_n = torch.arange(N, device=dneg.device)
        tidx = (ar_q[None, :] - ar_n[:, None]) % Q             # (N, Q)
        blocks = dq[ar_n[:, None], tidx]                       # (N, Q, g*C)
        dz_pre = torch.sum(blocks, 0, dtype=torch.float32).reshape(M, C)
        return (dz_pre[inv].to(dneg.dtype), None, None, None, None, None)


def sample_negatives_stratified(encoded: torch.Tensor, window_size: int,
                                n_negative: int, round_keys: torch.Tensor,
                                pool: Optional[torch.Tensor] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Permutation-stratified negatives, materialised
    (infonce.py:337-390): neg[b, w, n] = pool_flat[pi((s + g*n) mod M)],
    s = b*W + w, g = M / N, pi the keyed Feistel permutation of [0, M).
    Raises where the shapes leave its domain.  Returns (flat index
    (B*W, N), negatives (B, W, N, C))."""
    B = encoded.shape[0]
    if pool is None:
        pool = encoded
    Bp, S, C = pool.shape
    N = n_negative
    M, g, nbits = stratified_domain_check(Bp, S, N, B, window_size)
    s = torch.arange(B * window_size, device=pool.device)[:, None]
    n = torch.arange(N, device=pool.device)[None, :]
    idx = feistel_permute((s + g * n) & (M - 1), round_keys, nbits)
    inv = feistel_inverse(torch.arange(M, device=pool.device), round_keys,
                          nbits)
    neg = _WindowedPermutationGather.apply(pool.reshape(M, C), idx, inv, B,
                                           window_size, N)
    return idx, neg


# ---- scorers ----------------------------------------------------------------

def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 a @ b of two float32 or bf16 batches.  On the card, bf16
    products accumulate in float32 and come out float32 (cuBLAS), with no
    float32 copy of the inputs; the CPU casts first."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


class _ScorePair(torch.autograd.Function):
    """``_score_pair`` (infonce.py:39-74): float32 positive scores (K, B, W)
    and negative scores (K, B, W, N), means over C.  The backward casts
    the score cotangents to the compute dtype once, so dpred, dpos and
    dneg (the scatter's updates) stay in it."""

    @staticmethod
    def forward(ctx, preds, pos, neg, inv_c):
        K, B, W, C = preds.shape
        N = neg.shape[2]
        ps = (preds.float() * pos.float()).sum(-1) * inv_c
        pb = preds.permute(1, 2, 0, 3).reshape(B * W, K, C)
        ns = _bmm_f32(pb, neg.reshape(B * W, N, C).transpose(1, 2))
        ctx.save_for_backward(preds, pos, neg, pb)
        ctx.inv_c = inv_c
        return ps, ns.reshape(B, W, K, N).permute(2, 0, 1, 3) * inv_c

    @staticmethod
    def backward(ctx, dps, dns):
        preds, pos, neg, pb = ctx.saved_tensors
        K, B, W, C = preds.shape
        N = neg.shape[2]
        dt = preds.dtype
        dps_c = (dps * ctx.inv_c).to(dt)[..., None]           # (K, B, W, 1)
        dn = (dns * ctx.inv_c).to(dt).permute(1, 2, 0, 3) \
            .reshape(B * W, K, N)
        dpn = torch.bmm(dn, neg.reshape(B * W, N, C))         # (BW, K, C)
        dpred = dps_c * pos + dpn.reshape(B, W, K, C).permute(2, 0, 1, 3)
        dpos = dps_c * preds
        dneg = None
        if ctx.needs_input_grad[2]:
            dneg = torch.bmm(dn.transpose(1, 2), pb).reshape(B, W, N, C)
        return dpred, dpos, dneg, None


def score_pair(preds: torch.Tensor, pos: torch.Tensor, neg: torch.Tensor,
               inv_c: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 (pos scores (K, B, W), neg scores (K, B, W, N)) of
    predictions and positives (K, B, W, C) and negatives (B, W, N, C)."""
    return _ScorePair.apply(preds, pos, neg, inv_c)


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


# ---- the criterion ------------------------------------------------------------

class NoneCriterion(nn.Module):
    """The zero loss of ``--cpc_mode none`` (infonce.py:84-90): losses and
    accuracies one zero each, outside any graph.  A train step under it
    leaves the parameters as they are and advances Adam's count, as JAX's
    zero gradients do (parallel/train_step.py)."""

    def forward(self, c_feature: torch.Tensor, encoded: torch.Tensor,
                label=None, train: bool = False, **streams
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        z = torch.zeros(1, device=c_feature.device)
        return z, z


class _Embed(nn.Module):
    """The speaker table under flax ``nn.Embed``'s parameter name,
    ``embedding (n, E)``; seeded N(0, 1 / n)."""

    def __init__(self, n: int, features: int,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.embedding = nn.Parameter(
            torch.randn(n, features, generator=generator) / n ** 0.5)


class CPCUnsupervisedCriterion(nn.Module):
    """K-step InfoNCE with within-batch negatives (infonce.py:449).

    ``forward(c, z, label, train=False, generator=None, round_keys=None,
    seed=None, neg_seed=None, negatives=None) -> (losses (K,), acc (K,))``;
    ``train=True`` runs the heads' dropout and needs ``seed``
    (ops/dropout.py).  The stratified samplers use ``round_keys``, the
    exact and rolled ones draw their indices from ``neg_seed`` (a (1,)
    int64 tensor, ``dropout.negative_indices``) unless ``negatives`` =
    (batch indices, time offsets) gives them; what is not given is drawn
    from ``generator``."""

    def __init__(self, n_predicts: int, dim_output_ar: int,
                 dim_output_encoder: int, negative_sampling_ext: int,
                 size_input_seq: int = 128, sampling_mode: str = "auto",
                 rnn_mode: str = "transformer",
                 generator: Optional[torch.Generator] = None,
                 dropout: bool = False, attention_block: bool = False,
                 stop_grad_negatives: bool = False,
                 negative_sampling_scope: str = "device",
                 mode: Optional[str] = None, speaker_embedding: int = 0,
                 n_speakers: int = 0):
        super().__init__()
        if mode not in (None, "reverse"):
            raise ValueError("Invalid mode")
        if sampling_mode not in SAMPLING_MODES:
            raise ValueError(f"unknown sampling_mode {sampling_mode!r}; "
                             f"expected one of {sorted(SAMPLING_MODES)}")
        if negative_sampling_scope not in SCOPES:
            raise ValueError(f"unknown negative_sampling_scope "
                             f"{negative_sampling_scope!r}; expected "
                             f"device|global")
        dim_input = dim_output_ar + speaker_embedding
        if rnn_mode == "transformer" and dim_input != dim_output_encoder:
            raise ValueError("transformer heads need hiddenGar + "
                             "speakerEmbedding == hiddenEncoder")
        self.mode = mode
        self.n_predicts = n_predicts
        self.dim_output_encoder = dim_output_encoder
        self.negative_sampling_ext = negative_sampling_ext
        self.sampling_mode = sampling_mode
        self.stop_grad_negatives = stop_grad_negatives
        self.negative_sampling_scope = negative_sampling_scope
        if speaker_embedding > 0:
            self.speakerEmb = _Embed(n_speakers, speaker_embedding,
                                     generator)
        self.wPrediction = PredictionNetwork(
            n_predicts, dim_output_encoder, rnn_mode,
            size_input_seq - n_predicts, generator, dropout,
            attention_block, dim_input)

    def sampler(self, B: int, S: int) -> str:
        """The sampler a (B, S) batch resolves to (infonce.py:549-581):
        "fused stratified" (the scatter-free scorer), "stratified" (the
        materialised sampler), "exact" or "rolled"."""
        W = S - self.n_predicts
        N = self.negative_sampling_ext
        global_pool = self.negative_sampling_scope == "global"
        mode = self.sampling_mode
        if mode == "auto":
            mode = ("stratified"
                    if (not global_pool and not self.stop_grad_negatives
                        and stratified_shapes_ok(B, S, N, B, W))
                    else "exact")
        if mode == "stratified" and not (self.stop_grad_negatives
                                         or global_pool):
            return "fused stratified"
        return mode

    def forward(self, c_feature: torch.Tensor, encoded: torch.Tensor,
                label=None, train: bool = False,
                generator: Optional[torch.Generator] = None,
                round_keys: Optional[torch.Tensor] = None,
                seed: Optional[torch.Tensor] = None,
                neg_seed: Optional[torch.Tensor] = None,
                negatives: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.mode == "reverse":
            encoded, c_feature = encoded.flip(1), c_feature.flip(1)
        B, S, _ = c_feature.shape
        K = self.n_predicts
        W = S - K
        N = self.negative_sampling_ext
        C = self.dim_output_encoder
        mode = self.sampler(B, S)
        # every rank's batch; on one device the local batch (module doc)
        pool = gather_rows(encoded) \
            if self.negative_sampling_scope == "global" else None
        if mode in ("fused stratified", "stratified") and round_keys is None:
            round_keys = torch.randint(0, 2 ** 32, (ROUNDS,),
                                       generator=generator,
                                       dtype=torch.int64)
        pos = stack_positives(encoded, K, W)                 # (K, B, W, C)
        c = c_feature[:, :W]
        if hasattr(self, "speakerEmb"):
            emb = self.speakerEmb.embedding[label.long()]       # (B, E)
            c = torch.cat([c, emb[:, None].expand(B, W, -1).to(c.dtype)],
                          dim=2)
        preds = self.wPrediction(c, train, seed)             # (K, B, W, C)

        if mode == "fused stratified":
            # the (B, W, N, C) negatives never materialise
            M, g, nbits = stratified_domain_check(B, S, N, B, W)
            ar = torch.arange(M, device=encoded.device)
            perm = feistel_permute(ar, round_keys, nbits)
            inv = feistel_inverse(ar, round_keys, nbits)
            pos_score, neg_score = stratified_scores(
                preds, pos, encoded.reshape(M, -1), perm, inv, g, 1.0 / C)
            return info_nce_reduce(pos_score, neg_score, B * W)

        if mode == "stratified":
            _, neg = sample_negatives_stratified(encoded, W, N, round_keys,
                                                 pool)
        else:
            if negatives is None:
                if neg_seed is None:
                    neg_seed = torch.randint(0, 2 ** 32, (1,),
                                             generator=generator,
                                             dtype=torch.int64)
                shape = (B, N, W) if mode == "exact" else (B, N)
                Bp = B if pool is None else pool.shape[0]
                negatives = dropout.negative_indices(
                    neg_seed.to(encoded.device), shape, Bp, S)
            batch_idx, seq_off = (t.to(encoded.device) for t in negatives)
            sampler = sample_negatives if mode == "exact" \
                else sample_negatives_rolled
            _, neg = sampler(encoded, W, N, batch_idx, seq_off, pool)
        if self.stop_grad_negatives:
            # no gradient through the negatives, plain float32 products as
            # the JAX einsums (infonce.py:582-591): K8 never runs
            neg = neg.detach()
            pos_score = torch.einsum("kbwc,kbwc->kbw", preds.float(),
                                     pos.float()) / C
            neg_score = torch.einsum("kbwc,bwnc->kbwn", preds.float(),
                                     neg.float()) / C
        else:
            pos_score, neg_score = score_pair(preds, pos, neg, 1.0 / C)
        BW = B * W
        return info_nce_reduce(pos_score.reshape(K, BW),
                               neg_score.reshape(K, BW, N), BW)


def check_kernels(config: CPCConfig) -> None:
    """Raise ValueError, naming the flag, for a config whose criterion the
    port cannot run on the card: for the transformer heads their widths
    (hiddenGar + speakerEmbedding == hiddenEncoder, as the JAX heads need
    too) and the gates of K2 and K3, for the LSTM heads K1's at H =
    hiddenEncoder, and K8's for every head type: the heads' K2 takes S =
    sizeWindow // 160 - nPredicts up to 4096 frames (``--sizeWindow`` up
    to 657439 at the default 12 predictions) at any dk, K1 H up to 8192.  A
    refused shape is run by no plain version in its place; the message
    names the flag and the limit.  Under ``CPC_ATTN_BLOCK=1`` the
    heads run K6 where its gate takes the shape and K2 elsewhere, as the
    JAX package runs its whole-block kernel only where its own gate takes
    it (at ``--hiddenEncoder 512`` or ``--sizeWindow 40960`` neither
    does).  The kernels take z's dtype (``encoding_dtype``: float32 under
    MFCC, LFB and batchNorm).  Runs without a card."""
    problems = []
    D, H, W = config.hiddenEncoder, config.hiddenGar, config.sizeWindow
    E = config.speakerEmbedding
    S = W // 160 - config.nPredicts
    dtype = encoding_dtype(config)
    nheads, dff = 8, 2048   # the heads' (StackedTransformerHeads defaults)
    if config.rnnMode == "transformer":
        if H + E != D:
            problems.append(f"--hiddenGar {H} with --hiddenEncoder {D}"
                            + (f" and --speakerEmbedding {E}" if E else "")
                            + ": the transformer prediction heads (--rnnMode "
                            f"transformer) take hiddenGar + speakerEmbedding "
                            f"== hiddenEncoder, in the JAX package too")
        if D % nheads:
            problems.append(f"--hiddenEncoder {D}: the heads' {nheads} "
                            f"attention heads need a multiple of {nheads}")
        else:
            dk = D // nheads
            why = head_attention.supported(S, dk)
            if why:
                problems.append(f"--sizeWindow {W} / --hiddenEncoder {D} "
                                f"(K2, the heads' attention over S = {S} "
                                f"frames, dk = {dk}): {why}")
        why = ffn.supported(D, dff, dtype)
        if why:
            problems.append(f"--hiddenEncoder {D} (K3, the heads' FFN "
                            f"tail): {why}")
    elif config.rnnMode == "LSTM":
        why = lstm.supported(D)
        if why:
            problems.append(f"--hiddenEncoder {D} (K1, the --rnnMode LSTM "
                            f"heads): {why}")
    why = scatter_add.supported(D, dtype)
    if why:
        problems.append(f"--hiddenEncoder {D} (K8, the exact and rolled "
                        f"samplers' backward): {why}")
    if problems:
        raise ValueError("the port's kernels refuse this config: " +
                         "; ".join(problems))


def build_criterion(config: CPCConfig,
                    generator: Optional[torch.Generator] = None,
                    n_speakers: int = 0) -> nn.Module:
    """The criterion of the CPC objective for ``config``
    (cpc_audio_tpu/train.py:37-58): :class:`NoneCriterion` under
    ``--cpc_mode none``, else the InfoNCE criterion with its ``--rnnMode``
    heads, ``--cpc_mode reverse`` and a speaker embedding over
    ``n_speakers`` speakers where ``--speakerEmbedding`` > 0; the
    transformer heads run the whole-block kernel under
    ``CPC_ATTN_BLOCK=1``.  ``negative_sampling_scope="global"`` draws
    from every rank's batch (one device: the local batch), as JAX
    does."""
    if config.cpc_mode == "none":
        return NoneCriterion()
    check_kernels(config)
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
        attention_block=fused_layer_switches()[1],
        stop_grad_negatives=config.stopGradNegatives,
        negative_sampling_scope=config.negative_sampling_scope,
        mode=config.cpc_mode,
        speaker_embedding=config.speakerEmbedding,
        n_speakers=n_speakers)
