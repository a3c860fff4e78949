// K2 backward: causal attention with Shaw relative positions on the
// tensor cores (the body at every S <= 4096 and dk <= 4096: past dk 512 on
// thread-block clusters of ceil(dk / 512) CTAs).
//
// Replaces cpc_audio_tpu/ops/pallas/head_attention.py `_bwd_kernel`
// (called through `_fr_bwd`).  Recompute-style: per (k, batch row b, head
// h) the probabilities p are recomputed from q, k and krel, and with the
// forward's dropout factors r (dropout.cuh, keyed on (k, b, h, i, j)):
//   dv_j    = sum_i round(p_ij r_ij) do_i
//   dp_ij   = (do_i . v_j) r_ij,   ds_ij = round(p_ij (dp_ij - sum_j p_ij dp_ij) / sqrt(dk))
//   dq_i    = sum_j ds_ij (k_j + krel[:, j - i + S - 1])
//   dk_j    = sum_i ds_ij q_i
//   dkrel[:, j - i + S - 1] += ds_ij q_i      (summed over b and h)
// round() is the rounding to the input dtype that the Pallas kernel
// applies (none in float32); c_i = sum_j p_ij dp_ij is formed from p and
// dp in float32, as the Pallas kernel does.
//
// Design (relpos_attention_tc.cuh, on K5's body): no (S, S) tile anywhere,
// blocks of 4 warps over tiles of 64 rows (32 past 128 bf16 planes' values
// a row, 16 at DKP 512, where each warp forms its quarter of every sum
// over dk, QP's band, s and dp, and the partials are summed w 0 + 1 + 2 +
// 3 through 8 KB of shared memory), cp.async staging, products on
// mma.sync; four kernels:
//   1. `relpos_tc_bwd_rows`, one block per (query tile, head), K5's row
//      kernel: a first walk over the key tiles up to the diagonal forms s
//      (q . k^T plus the band of the window product QP) and dp = do . v^T
//      and keeps each row's m, l and c online; a second forms p and ds,
//      dq += ds . k, stages ds as its band U and adds U . krel[:,
//      window]^T.  It writes dq and the rows' (m, 1/l, c).
//   2. `relpos_tc_bwd_cols`, one block per (key tile, head), K5's column
//      kernel: k and v stay while the query tiles stream through (q, do,
//      the window, the rows' statistics); the block forms each query
//      tile's QP band together, then s^T = k . q^T and dp^T = v . do^T by
//      key rows, so that (p r)^T and ds^T are the A operands of dv += (p
//      r)^T . do and dk += ds^T . q.
//   3. `relpos_tc_bwd_diag`, dkrel.  Tile pair (qt, kt) meets the window of
//      its diagonal qt - kt, so one block per (diagonal, k, group of (b, h)
//      heads) walks the pairs of its diagonal over its heads with the
//      window staged once, recomputes p and ds from the rows' statistics,
//      stages ds as U and accumulates q^T . U (dk x 2T) in registers; it
//      writes that window's partial sum.
//   4. `dkrel_windows_reduce` sums each krel column over the groups and the
//      (at most two) windows that hold it, in a fixed order: no floating-
//      point atomics, and the result does not depend on block scheduling.
// Past dk 512 the cluster body (relpos_attention_tc.cuh): in each of the
// three passes CTA c of a tile's cluster runs DKP 512's kernel on dk
// columns [512 c, 512 c + 512): its slab of dq, dk, dv and of dkrel's rows,
// the partial band, s and dp of its warps summed in the CTA and then over
// the cluster, CTA 0 + 1 + ..., through distributed shared memory.
// In float32, q, k, v, do and krel are split once a call into two bf16
// planes, and p r, ds enter their products as two planes: three split
// products a product, as K5's backward (ops/head_attention.py
// `relpos_attention_bwd_split`).  In bf16, p r and ds are rounded to bf16,
// one plane each, as the JAX kernel rounds them.
//
// What bounds it on an H100: at K 12, B 32, 8 heads, S 116, dk 32 the call
// reads q, k, v, do (91 MB in bf16) and writes dq, dk, dv (68 MB) and
// dkrel: 48 us at 3.35 TB/s; its 2.1 GFLOP (16 dk a causal pair) take 2 us
// at the bf16 peak.  The rows' statistics (4.3 MB) and the partial windows
// (a few MB) come on top, and the recomputed scores take three walks over
// the tile pairs (rows twice, columns, diagonals).
#include "relpos_attention_tc.cuh"

namespace {

using cpc::k2::bf16;
namespace k2 = cpc::k2;
namespace k5 = cpc::k5;

// bf16 planes a float32 operand of the backward: two, as K5's
constexpr int kF32Planes = 2;
// blocks of the diagonal pass to aim at: the heads of a k are split into
// groups so that (diagonals x K x groups) comes near this
constexpr int kDiagBlocks = 1024;

// The cluster body's exchange block (CL), bytes.
template <typename T, int DKP, bool CL>
constexpr size_t exchange_bytes() {
  return CL ? k2::kExchangeFloats<k5::Geom<T, DKP>, true> * sizeof(float)
            : 0;
}

// Shared memory of the backward's kernels at `bufs` buffers: q, do; (k,
// v, window) buffers; the band staging (QP, then U); at kSplitK the
// partials (float32 at DKP 512: 221 KB); in the cluster body the exchange
// block (4 KB)
template <typename T, int DKP, bool CL = false>
constexpr size_t rows_bytes(int bufs) {
  using G = k5::Geom<T, DKP>;
  using W = k2::Win<G>;
  return (2 + 2 * bufs) * G::kTileElems * sizeof(bf16) +
         bufs * W::kr_elems(DKP) * sizeof(bf16) + W::kBandBytes +
         W::kRedBytes + exchange_bytes<T, DKP, CL>();
}

// k, v; (q, do, window, statistics) buffers; the QP band; the partials;
// the exchange block
template <typename T, int DKP, bool CL = false>
constexpr size_t cols_bytes(int bufs) {
  using G = k5::Geom<T, DKP>;
  using W = k2::Win<G>;
  return (2 + 2 * bufs) * G::kTileElems * sizeof(bf16) +
         bufs * (W::kr_elems(DKP) * sizeof(bf16) +
                 3 * G::kTile * sizeof(float)) +
         W::kQpBytes + W::kRedBytes + exchange_bytes<T, DKP, CL>();
}

// (q, k, v, do, statistics) buffers; the window; the band staging; the
// partials; the exchange block
template <typename T, int DKP, bool CL = false>
constexpr size_t diag_bytes(int bufs) {
  using G = k5::Geom<T, DKP>;
  using W = k2::Win<G>;
  return bufs * (4 * G::kTileElems * sizeof(bf16) +
                 3 * G::kTile * sizeof(float)) +
         W::kr_elems(DKP) * sizeof(bf16) + W::kBandBytes + W::kRedBytes +
         exchange_bytes<T, DKP, CL>();
}

// At kSplitK: the band QP of the 16 rows of staged tile A x the window's
// quarter blocks Kr into QPs (rows ldq apart), and then s = A . Bs^T and
// dp = Ad . Bd^T of the same rows (n8 tiles outside [n_lo, n_hi) left 0):
// each warp forms its quarter c0 of dk, and the partials are summed
// through red.  Ends with the band readable by every warp; the caller
// syncs before QPs or red are stored again.
template <typename G>
__device__ __forceinline__ void band_and_scores(
    float s[G::kNT][4], float dp[G::kNT][4], float* QPs, int ldq,
    float* red, const bf16* A, const bf16* Kr, const bf16* Bs,
    const bf16* Ad, const bf16* Bd, int c0, int n_lo, int n_hi) {
  using W = k2::Win<G>;
  float qp[W::kBandNT][4];
  k2::zero_band<G>(qp);
  const int w = threadIdx.x >> 5;
  k2::window_product<G, G::kDV>(qp, A, 0, Kr + w * W::kr_elems(G::kDV), c0,
                                W::c_lo(0));
  k2::sum_band<G>(QPs, qp, red, ldq);
  k5::split_products<G>(s, dp, A, Bs, Ad, Bd, n_lo, n_hi, c0, red);
}

// The cluster body's band_and_scores: the band from the warps' quarter
// blocks Kr of the window times staged tile A, s = As . Bs^T and dp = Ad .
// Bd^T, each summed over the CTA's warps and then over the cluster
// (k2::cta_band, k2::cta_scores, k2::cluster_sums); a warp past dk (not
// `live`) adds 0.
template <typename G>
__device__ __forceinline__ void cluster_band_and_scores(
    float s[G::kNT][4], float dp[G::kNT][4], float* QPs, int ldq,
    float* red, float* X, const bf16* A, const bf16* Kr, const bf16* As,
    const bf16* Bs, const bf16* Ad, const bf16* Bd, int c0, int n_lo,
    int n_hi, bool live, int n_cta, bool& armed) {
  using W = k2::Win<G>;
  float qp[W::kBandNT][4];
  k2::zero_band<G>(qp);
  const int w = threadIdx.x >> 5;
  if (live)
    k2::window_product<G, G::kDV>(qp, A, 0, Kr + w * W::kr_elems(G::kDV),
                                  c0, W::c_lo(0));
  k2::cta_band<G>(qp, red, X, armed);
  if (live) {
    k5::rows_dot_rows<G, G::kDV>(s, As + c0, 0, Bs + c0, n_lo, n_hi);
    k5::rows_dot_rows<G, G::kDV>(dp, Ad + c0, 0, Bd + c0, n_lo, n_hi);
  } else {
    k2::zero_tile<G::kNT>(s);
    k2::zero_tile<G::kNT>(dp);
  }
  k2::cta_scores<G, true>(s, dp, red, X);
  k2::cluster_sums<G, true>(QPs, ldq, s, dp, X, n_cta, armed);
}

template <typename T, int DKP, bool CL = false>
struct Bwd {
  using G = k5::Geom<T, DKP>;
  using W = k2::Win<G>;
  static constexpr int kRowBufs =
      k2::pick_bufs(rows_bytes<T, DKP, CL>(1), rows_bytes<T, DKP, CL>(2));
  static constexpr int kColBufs =
      k2::pick_bufs(cols_bytes<T, DKP, CL>(1), cols_bytes<T, DKP, CL>(2));
  static constexpr int kDiagBufs =
      k2::pick_bufs(diag_bytes<T, DKP, CL>(1), diag_bytes<T, DKP, CL>(2));
  static_assert(rows_bytes<T, DKP, CL>(1) <= cpc::kSmemLimit &&
                    cols_bytes<T, DKP, CL>(1) <= cpc::kSmemLimit &&
                    diag_bytes<T, DKP, CL>(1) <= cpc::kSmemLimit,
                "K2 backward shared memory");
  static_assert(!CL || G::kSplitK, "the cluster body runs DKP 512's tiles");
};

// The window of tile pair (qt, kt): padded krel column sk - (qt - kt + 1) T.
template <typename G>
__device__ __forceinline__ int window_x0(int sk, int qt, int kt) {
  return sk - (qt - kt + 1) * G::kTile;
}

// The warp's ds of one tile (query rows r0.. x key tile k0) from s
// (scaled and masked) and dp, in s: 0 off the causal pairs and past S,
// rounded to T where the JAX kernel rounds it.
template <typename G, typename T>
__device__ __forceinline__ void ds_of(float s[G::kNT][4],
                                      const float dp[G::kNT][4],
                                      const float m[2], const float inv_l[2],
                                      const float c[2], int r0, int k0,
                                      int S, const cpc::Dropout& drop,
                                      uint32_t keep, float inv_sqrt) {
#pragma unroll
  for (int nt = 0; nt < G::kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      const int i = r0 + k5::row_of(e), j = k0 + k5::col_of(nt, e);
      float ds = 0.0f;
      if (j <= i && i < S) {
        const float p = expf(s[nt][e] - m[h]) * inv_l[h];
        const float r = k5::kept_factor(drop, keep, nt, e);
        ds = cpc::round_to<T>(p * (dp[nt][e] * r - c[h]) * inv_sqrt);
      }
      s[nt][e] = ds;
    }
}

// ---------------------------------------------------------------------------
// kernel 1: by query tile -> dq and the rows' statistics
// ---------------------------------------------------------------------------

template <typename T, int DKP, bool CL = false>
__global__ void __launch_bounds__(k5::kThreads) relpos_tc_bwd_rows(
    k2::Heads H, const bf16* __restrict__ krp, int sk, T* __restrict__ dq,
    float* __restrict__ stats, int N, float inv_sqrt, cpc::Dropout drop) {
  using C = Bwd<T, DKP, CL>;
  using G = typename C::G;
  using W = typename C::W;
  constexpr int TE = G::kTileElems;
  constexpr int NB = C::kRowBufs;
  constexpr int KRE = W::kr_elems(DKP);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ds = Qs + TE;              // do
  bf16* Ks = Ds + TE;              // NB buffers
  bf16* Vs = Ks + NB * TE;         // NB buffers
  bf16* Kr = Vs + NB * TE;         // NB windows
  float* QPs = reinterpret_cast<float*>(Kr + NB * KRE);   // the band
  bf16* Us = reinterpret_cast<bf16*>(QPs);                 // U over it
  float* Red = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(QPs) + W::kBandBytes);   // kSplitK
  float* X = Red + W::kRedBytes / sizeof(float);                // CL

  // the cluster body: the CTA's slab of dk columns from col0, of the
  // padded width dkr
  const k2::Cta cta = k2::this_cta<CL>();
  const int dkr = k2::plane_rows<CL, DKP>(H.dk);
  bool armed = false;   // CL: a cluster arrive outstanding
  const int n = CL ? blockIdx.x / cta.n : blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;   // every head's longest first
  const int q0 = qt * G::kTile;
  const int S = H.S;
  const int nb = n / H.nheads;
  const int kk = nb / H.n_batch;
  const int warp = threadIdx.x >> 5;
  const int rw = warp % G::kRowWarps;
  const int c0 = warp / G::kRowWarps * G::kDV;
  const int r0 = q0 + rw * 16;
  const int c_lo = W::c_lo(rw);
  // the CTA's columns from col0, the warp's sl.live from sl.gw (none
  // past dk: no products)
  const k2::Slab sl = k2::slab<CL, G>(cta, H.dk, warp);
  const int col0 = sl.col0;
  const bool live = sl.live > 0;
  const uint32_t row_key = cpc::attention_row_key(
      drop, kk, H.n_batch, nb % H.n_batch, H.nheads, n % H.nheads);
  auto stage_tile = [&](int kt) {   // key tile kt into buffer kt % NB
    const int b = NB == 2 ? kt & 1 : 0;
    k2::stage_head<G, DKP, CL>(Ks + b * TE, H, 1, n, kt * G::kTile, col0);
    k2::stage_head<G, DKP, CL>(Vs + b * TE, H, 2, n, kt * G::kTile, col0);
    if constexpr (G::kSplitK)
      k2::stage_quarters<G, DKP, G::kDV, CL>(
          Kr + b * KRE, krp, kk, sk, 0, window_x0<G>(sk, qt, kt), dkr, col0,
          H.dk);
    else
      k2::stage_window<G, DKP, DKP>(Kr + b * KRE, krp, kk, sk, 0,
                                    window_x0<G>(sk, qt, kt));
    cpc::mma::cp_async_commit();
  };
  // s (scaled, biased, masked) and dp of key tile kt in buffer buf
  auto scores = [&](float (&s)[G::kNT][4], float (&dp)[G::kNT][4], int kt,
                    int buf, int n_hi) {
    if constexpr (CL) {
      cluster_band_and_scores<G>(s, dp, QPs, W::kRowF, Red, X, Qs,
                                 Kr + buf * KRE, Qs, Ks + buf * TE, Ds,
                                 Vs + buf * TE, c0, 0, n_hi, live, cta.n,
                                 armed);
    } else if constexpr (G::kSplitK) {
      band_and_scores<G>(s, dp, QPs, W::kRowF, Red, Qs, Kr + buf * KRE,
                         Ks + buf * TE, Ds, Vs + buf * TE, c0, 0, n_hi);
    } else {
      float qp[W::kBandNT][4];
      k2::zero_band<G>(qp);
      k2::window_product<G, DKP>(qp, Qs, rw * 16, Kr + buf * KRE, 0, c_lo);
      if (c0 == 0) k2::store_band<G>(QPs, qp, rw, W::kRowF);
      if constexpr (G::kColWarps > 1)
        __syncthreads();
      else
        __syncwarp();
      k5::rows_dot_rows<G, DKP>(s, Qs, rw * 16, Ks + buf * TE, 0, n_hi);
      k5::rows_dot_rows<G, DKP>(dp, Ds, rw * 16, Vs + buf * TE, 0, n_hi);
    }
    k2::bias_scale_mask<G>(s, QPs, W::kRowF, rw, q0, kt * G::kTile,
                           inv_sqrt);
  };
  // U over the row group's band once its scores are read there
  auto stage_u = [&](float (&ds)[G::kNT][4]) {
    if constexpr (G::kColWarps > 1)
      __syncthreads();   // the pair's other warp has read the band
    else
      __syncwarp();
    if (c0 == 0) k2::store_u<G>(Us, ds, rw);
    if constexpr (G::kColWarps > 1)
      __syncthreads();
    else
      __syncwarp();
  };

  k2::stage_head<G, DKP, CL>(Qs, H, 0, n, q0, col0);
  k2::stage_head<G, DKP, CL>(Ds, H, 3, n, q0, col0);
  stage_tile(0);

  // ---- pass 1: m, l and c = sum_j p dp, online over the key tiles ----
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f},
        c[2] = {0.0f, 0.0f};
  for (int kt = 0; kt <= qt; ++kt) {
    const int buf = NB == 2 ? kt & 1 : 0;
    const int n_hi = kt == qt ? 2 * rw + 2 : G::kNT;
    const uint32_t keep =
        k5::keep_bits<G>(drop, row_key, r0, kt * G::kTile, 0, n_hi, S);
    if (NB == 2 && kt < qt) {
      stage_tile(kt + 1);
      cpc::mma::cp_async_wait<1>();
    } else {
      cpc::mma::cp_async_wait<0>();
    }
    __syncthreads();
    float s[G::kNT][4], dp[G::kNT][4];
    scores(s, dp, kt, buf, n_hi);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < G::kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
    float rescale[2], ls[2] = {0.0f, 0.0f}, lc[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = k5::quad_max(mx[h]);
      rescale[h] = expf(m[h] - mx[h]);
      m[h] = mx[h];
    }
#pragma unroll
    for (int nt = 0; nt < G::kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] - m[e >> 1]);
        ls[e >> 1] += p;
        lc[e >> 1] += p * dp[nt][e] * k5::kept_factor(drop, keep, nt, e);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] = l[h] * rescale[h] + k5::quad_sum(ls[h]);
      c[h] = c[h] * rescale[h] + k5::quad_sum(lc[h]);
    }
    __syncthreads();   // the buffer is restaged
    if (NB == 1 && kt < qt) stage_tile(kt + 1);
  }
  float inv_l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    inv_l[h] = 1.0f / l[h];
    c[h] *= inv_l[h];
  }

  // ---- pass 2: p, ds; dq += ds . k + U . krel[:, window]^T ----
  const bool resident = NB == 2 && qt <= 1;   // both tiles still staged
  if (!resident) stage_tile(0);
  float dqa[G::kDV / 8][4];
#pragma unroll
  for (int nt = 0; nt < G::kDV / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[nt][e] = 0.0f;
  for (int kt = 0; kt <= qt; ++kt) {
    const int buf = NB == 2 ? kt & 1 : 0;
    const int n_hi = kt == qt ? 2 * rw + 2 : G::kNT;
    const uint32_t keep =
        k5::keep_bits<G>(drop, row_key, r0, kt * G::kTile, 0, n_hi, S);
    if (!resident) {
      if (NB == 2 && kt < qt) {
        stage_tile(kt + 1);
        cpc::mma::cp_async_wait<1>();
      } else {
        cpc::mma::cp_async_wait<0>();
      }
    }
    __syncthreads();
    float s[G::kNT][4], dp[G::kNT][4];
    scores(s, dp, kt, buf, n_hi);
    ds_of<G, T>(s, dp, m, inv_l, c, r0, kt * G::kTile, S, drop, keep,
                    inv_sqrt);
    if (live)
      k5::acc_times_rows<G, false>(dqa, s, Ks + buf * TE + c0, 0, n_hi / 2);
    stage_u(s);
    if constexpr (G::kSplitK) {   // the warp's quarter block of the window
      if (live)
        k2::unskew_product<G, G::kDV>(
            dqa, Us, 0, Kr + buf * KRE + warp * W::kr_elems(G::kDV), 0,
            c_lo);
    }
    else
      k2::unskew_product<G, DKP>(dqa, Us, rw * 16, Kr + buf * KRE, c0,
                                 c_lo);
    __syncthreads();   // the buffer, the band and U are reused next
    if (!resident && NB == 1 && kt < qt) stage_tile(kt + 1);
  }
  const float one[2] = {1.0f, 1.0f};
  const int D = H.nheads * H.dk;
  if constexpr (CL)   // the warp's columns from sl.gw
    k5::store_rows<G>(dq + H.natural(n, D) + sl.gw, dqa, r0, 0, S, sl.live,
                      one, D);
  else
    k5::store_rows<G>(dq + H.natural(n, D), dqa, r0, c0, S, H.dk, one, D);
  if (c0 == 0 && cta.rank == 0 && (threadIdx.x & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = r0 + k5::row_of(2 * h);
      if (i < S) {
        const size_t at = (size_t)n * S + i;
        stats[at] = m[h];
        stats[(size_t)N * S + at] = inv_l[h];
        stats[2 * (size_t)N * S + at] = c[h];
      }
    }
  }
  if (armed) k2::cluster_wait();   // the cluster has read the block
}

// The statistics (m, 1/l, c) of head n's query tile q0 into st (3 x kTile).
template <typename G>
__device__ __forceinline__ void stage_stats(float* st,
                                            const float* __restrict__ stats,
                                            int N, int S, int n, int q0) {
  for (int idx = threadIdx.x; idx < 3 * G::kTile; idx += k5::kThreads) {
    const int a = idx / G::kTile, i = q0 + idx % G::kTile;
    if (i < S)
      cpc::mma::cp_async4(st + idx, stats + (a * (size_t)N + n) * S + i);
  }
}

// ---------------------------------------------------------------------------
// kernel 2: by key tile -> dk and dv
// ---------------------------------------------------------------------------

template <typename T, int DKP, bool CL = false>
__global__ void __launch_bounds__(k5::kThreads) relpos_tc_bwd_cols(
    k2::Heads H, const bf16* __restrict__ krp, int sk,
    T* __restrict__ dk_out, T* __restrict__ dv,
    const float* __restrict__ stats, int N, float inv_sqrt,
    cpc::Dropout drop) {
  using C = Bwd<T, DKP, CL>;
  using G = typename C::G;
  using W = typename C::W;
  constexpr int TE = G::kTileElems;
  constexpr int NB = C::kColBufs;
  constexpr int KRE = W::kr_elems(DKP);
  constexpr int kStats = 3 * G::kTile;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + TE;
  bf16* Qs = Vs + TE;              // NB buffers
  bf16* Ds = Qs + NB * TE;         // NB buffers of do
  bf16* Kr = Ds + NB * TE;         // NB windows
  float* QPs = reinterpret_cast<float*>(Kr + NB * KRE);
  float* St = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(QPs) + W::kQpBytes);   // NB x kStats
  float* Red = St + NB * kStats;   // kSplitK
  float* X = Red + W::kRedBytes / sizeof(float);   // CL

  const k2::Cta cta = k2::this_cta<CL>();
  const int dkr = k2::plane_rows<CL, DKP>(H.dk);
  bool armed = false;
  const int n = CL ? blockIdx.x / cta.n : blockIdx.x;
  const int kt = blockIdx.y;       // most query tiles first
  const int k0 = kt * G::kTile;
  const int n_qt = gridDim.y;
  const int S = H.S;
  const int nb = n / H.nheads;
  const int kk = nb / H.n_batch;
  const int warp = threadIdx.x >> 5;
  const int rw = warp % G::kRowWarps;   // its 16 keys, and the QP rows
  const int c0 = warp / G::kRowWarps * G::kDV;
  const k2::Slab sl = k2::slab<CL, G>(cta, H.dk, warp);
  const int col0 = sl.col0;
  const bool live = sl.live > 0;
  const uint32_t row_key = cpc::attention_row_key(
      drop, kk, H.n_batch, nb % H.n_batch, H.nheads, n % H.nheads);
  auto stage_tile = [&](int qt) {   // query tile qt into its buffer
    const int b = NB == 2 ? (qt - kt) & 1 : 0, q0 = qt * G::kTile;
    k2::stage_head<G, DKP, CL>(Qs + b * TE, H, 0, n, q0, col0);
    k2::stage_head<G, DKP, CL>(Ds + b * TE, H, 3, n, q0, col0);
    if constexpr (G::kSplitK)
      k2::stage_quarters<G, DKP, G::kDV, CL>(
          Kr + b * KRE, krp, kk, sk, 0, window_x0<G>(sk, qt, kt), dkr, col0,
          H.dk);
    else
      k2::stage_window<G, DKP, DKP>(Kr + b * KRE, krp, kk, sk, 0,
                                    window_x0<G>(sk, qt, kt));
    stage_stats<G>(St + b * kStats, stats, N, S, n, q0);
    cpc::mma::cp_async_commit();
  };

  k2::stage_head<G, DKP, CL>(Ks, H, 1, n, k0, col0);
  k2::stage_head<G, DKP, CL>(Vs, H, 2, n, k0, col0);
  stage_tile(kt);

  float dka[G::kDV / 8][4], dva[G::kDV / 8][4];
#pragma unroll
  for (int nt = 0; nt < G::kDV / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[nt][e] = dva[nt][e] = 0.0f;

  for (int qt = kt; qt < n_qt; ++qt) {
    const int buf = NB == 2 ? (qt - kt) & 1 : 0;
    const int q0 = qt * G::kTile;
    // on the diagonal tile, query n8 tiles before the warp's keys are
    // all masked
    const int n_lo = qt == kt ? 2 * rw : 0;
    const uint32_t keep = k5::keep_bits<G, true>(drop, row_key,
                                                 k0 + rw * 16, q0, n_lo,
                                                 G::kNT, S);
    if (NB == 2 && qt + 1 < n_qt) {
      stage_tile(qt + 1);
      cpc::mma::cp_async_wait<1>();
    } else {
      cpc::mma::cp_async_wait<0>();
    }
    __syncthreads();
    // the query tile's QP bands, row group rw by warp rw's pair (at
    // kSplitK by all four warps, a quarter of dk each, summed)
    const bf16* Qb = Qs + buf * TE;
    float st[G::kNT][4], dpt[G::kNT][4];   // (16 keys, kTile queries)
    if constexpr (CL) {
      cluster_band_and_scores<G>(st, dpt, QPs, W::kLdq, Red, X, Qb,
                                 Kr + buf * KRE, Ks, Qb, Vs, Ds + buf * TE,
                                 c0, n_lo, G::kNT, live, cta.n, armed);
    } else {
      {
        float qp[W::kBandNT][4];
        k2::zero_band<G>(qp);
        if constexpr (G::kSplitK) {
          k2::window_product<G, G::kDV>(
              qp, Qb, 0, Kr + buf * KRE + warp * W::kr_elems(G::kDV), c0,
              W::c_lo(0));
          k2::sum_band<G>(QPs, qp, Red, W::kLdq);
        } else {
          k2::window_product<G, DKP>(qp, Qb, rw * 16, Kr + buf * KRE, 0,
                                     W::c_lo(rw));
          if (c0 == 0) k2::store_band<G>(QPs, qp, rw, W::kLdq);
          __syncthreads();
        }
      }
      if constexpr (G::kSplitK) {
        k5::split_products<G>(st, dpt, Ks, Qb, Vs, Ds + buf * TE, n_lo,
                              G::kNT, c0, Red);
      } else {
        k5::rows_dot_rows<G, DKP>(st, Ks, rw * 16, Qb, n_lo, G::kNT);
        k5::rows_dot_rows<G, DKP>(dpt, Vs, rw * 16, Ds + buf * TE, n_lo,
                                  G::kNT);
      }
    }
    const float* sm = St + buf * kStats;
#pragma unroll
    for (int nt = 0; nt < G::kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jl = rw * 16 + k5::row_of(e), il = k5::col_of(nt, e);
        const int j = k0 + jl, i = q0 + il;
        float pd = 0.0f, ds = 0.0f;
        if (j <= i && i < S) {
          const float x =
              (st[nt][e] + k2::band_at(QPs, il, jl, W::kLdq)) * inv_sqrt;
          const float p = expf(x - sm[il]) * sm[G::kTile + il];
          const float r = k5::kept_factor(drop, keep, nt, e);
          pd = p * r;
          ds = cpc::round_to<T>(p * (dpt[nt][e] * r - sm[2 * G::kTile + il]) *
                                inv_sqrt);
        }
        st[nt][e] = pd;
        dpt[nt][e] = ds;
      }
    if (live) {
      k5::acc_times_rows<G, false>(dva, st, Ds + buf * TE + c0, n_lo / 2,
                                   G::kNT / 2);
      k5::acc_times_rows<G, false>(dka, dpt, Qb + c0, n_lo / 2, G::kNT / 2);
    }
    __syncthreads();   // the buffer and the bands are reused next
    if (NB == 1 && qt + 1 < n_qt) stage_tile(qt + 1);
  }
  const float one[2] = {1.0f, 1.0f};
  const int D = H.nheads * H.dk;
  const size_t out = H.natural(n, D);
  if constexpr (CL) {   // the warp's columns from sl.gw
    k5::store_rows<G>(dk_out + out + sl.gw, dka, k0 + rw * 16, 0, S,
                      sl.live, one, D);
    k5::store_rows<G>(dv + out + sl.gw, dva, k0 + rw * 16, 0, S, sl.live,
                      one, D);
  } else {
    k5::store_rows<G>(dk_out + out, dka, k0 + rw * 16, c0, S, H.dk, one, D);
    k5::store_rows<G>(dv + out, dva, k0 + rw * 16, c0, S, H.dk, one, D);
  }
  if (armed) k2::cluster_wait();   // the cluster has read the block
}

// ---------------------------------------------------------------------------
// kernel 3: by tile diagonal -> dkrel's partial windows
// ---------------------------------------------------------------------------

template <typename T, int DKP, bool CL = false>
__global__ void __launch_bounds__(k5::kThreads) relpos_tc_bwd_diag(
    k2::Heads H, const bf16* __restrict__ krp, int sk,
    float* __restrict__ part, const float* __restrict__ stats, int N,
    int group, float inv_sqrt, cpc::Dropout drop) {
  using C = Bwd<T, DKP, CL>;
  using G = typename C::G;
  using W = typename C::W;
  using DS = k2::DkrelSplit<G, DKP>;
  constexpr int TE = G::kTileElems;
  constexpr int NB = C::kDiagBufs;
  constexpr int kStats = 3 * G::kTile;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // NB buffers each
  bf16* Ds = Qs + NB * TE;
  bf16* Ks = Ds + NB * TE;
  bf16* Vs = Ks + NB * TE;
  bf16* Kr = Vs + NB * TE;                          // the one window
  float* QPs = reinterpret_cast<float*>(Kr + W::kr_elems(DKP));  // band
  bf16* Us = reinterpret_cast<bf16*>(QPs);                         // U
  float* St = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(QPs) + W::kBandBytes);
  float* Red = St + NB * kStats;   // kSplitK
  float* X = Red + W::kRedBytes / sizeof(float);   // CL

  const k2::Cta cta = k2::this_cta<CL>();
  const int dkr = k2::plane_rows<CL, DKP>(H.dk);
  bool armed = false;
  const int delta = CL ? blockIdx.x / cta.n : blockIdx.x;   // qt - kt
  const int g = blockIdx.y, kk = blockIdx.z;
  const int n_qt = CL ? gridDim.x / cta.n : gridDim.x;
  const int S = H.S;
  const int heads = H.n_batch * H.nheads;   // of one k
  const int bh0 = g * group, n_bh = min(group, heads - bh0);
  const int per = n_qt - delta;           // pairs a head
  const int items = n_bh * per;
  const int warp = threadIdx.x >> 5;
  const int rw = warp % G::kRowWarps;
  const int c0 = warp / G::kRowWarps * G::kDV;
  const int c_lo = W::c_lo(rw);
  const int md0 = warp / DS::kColSplit * DS::kWD;
  const int cw0 = warp % DS::kColSplit * DS::kWC;
  // its d rows: its columns
  const k2::Slab sl = k2::slab<CL, G>(cta, H.dk, warp);
  const int col0 = sl.col0;
  const bool live = sl.live > 0;
  auto stage_item = [&](int it) {   // item it's tiles into its buffer
    const int b = NB == 2 ? it & 1 : 0;
    const int n = kk * heads + bh0 + it / per, qt = delta + it % per;
    const int q0 = qt * G::kTile, k0 = (qt - delta) * G::kTile;
    k2::stage_head<G, DKP, CL>(Qs + b * TE, H, 0, n, q0, col0);
    k2::stage_head<G, DKP, CL>(Ds + b * TE, H, 3, n, q0, col0);
    k2::stage_head<G, DKP, CL>(Ks + b * TE, H, 1, n, k0, col0);
    k2::stage_head<G, DKP, CL>(Vs + b * TE, H, 2, n, k0, col0);
    stage_stats<G>(St + b * kStats, stats, N, S, n, q0);
    cpc::mma::cp_async_commit();
  };

  if constexpr (G::kSplitK)
    k2::stage_quarters<G, DKP, G::kDV, CL>(
        Kr, krp, kk, sk, 0, window_x0<G>(sk, delta, 0), dkr, col0, H.dk);
  else
    k2::stage_window<G, DKP, DKP>(Kr, krp, kk, sk, 0,
                                  window_x0<G>(sk, delta, 0));
  stage_item(0);

  float acc[DS::kWD][DS::kWC][4];
#pragma unroll
  for (int a = 0; a < DS::kWD; ++a)
#pragma unroll
    for (int b = 0; b < DS::kWC; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][b][e] = 0.0f;

  for (int it = 0; it < items; ++it) {
    const int buf = NB == 2 ? it & 1 : 0;
    const int bh = bh0 + it / per, n = kk * heads + bh;
    const int qt = delta + it % per;
    const int q0 = qt * G::kTile, k0 = (qt - delta) * G::kTile;
    const int r0 = q0 + rw * 16;
    const int n_hi = delta == 0 ? 2 * rw + 2 : G::kNT;
    const uint32_t row_key = cpc::attention_row_key(
        drop, kk, H.n_batch, bh / H.nheads, H.nheads, bh % H.nheads);
    const uint32_t keep = k5::keep_bits<G>(drop, row_key, r0, k0, 0, n_hi, S);
    if (NB == 2 && it + 1 < items) {
      stage_item(it + 1);
      cpc::mma::cp_async_wait<1>();
    } else {
      cpc::mma::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Qb = Qs + buf * TE;
    float s[G::kNT][4], dp[G::kNT][4];
    if constexpr (CL) {
      cluster_band_and_scores<G>(s, dp, QPs, W::kRowF, Red, X, Qb, Kr, Qb,
                                 Ks + buf * TE, Ds + buf * TE, Vs + buf * TE,
                                 c0, 0, n_hi, live, cta.n, armed);
    } else if constexpr (G::kSplitK) {
      band_and_scores<G>(s, dp, QPs, W::kRowF, Red, Qb, Kr, Ks + buf * TE,
                         Ds + buf * TE, Vs + buf * TE, c0, 0, n_hi);
    } else {
      float qp[W::kBandNT][4];
      k2::zero_band<G>(qp);
      k2::window_product<G, DKP>(qp, Qb, rw * 16, Kr, 0, c_lo);
      if (c0 == 0) k2::store_band<G>(QPs, qp, rw, W::kRowF);
      if constexpr (G::kColWarps > 1)
        __syncthreads();
      else
        __syncwarp();
      k5::rows_dot_rows<G, DKP>(s, Qb, rw * 16, Ks + buf * TE, 0, n_hi);
      k5::rows_dot_rows<G, DKP>(dp, Ds + buf * TE, rw * 16, Vs + buf * TE,
                                0, n_hi);
    }
    k2::bias_scale_mask<G>(s, QPs, W::kRowF, rw, q0, k0, inv_sqrt);
    const float* sm = St + buf * kStats;
    float m[2], inv_l[2], c[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int il = rw * 16 + k5::row_of(2 * h);
      m[h] = sm[il];
      inv_l[h] = sm[G::kTile + il];
      c[h] = sm[2 * G::kTile + il];
    }
    ds_of<G, T>(s, dp, m, inv_l, c, r0, k0, S, drop, keep, inv_sqrt);
    // U over the row group's band once its scores are read there
    if constexpr (G::kColWarps > 1)
      __syncthreads();
    else
      __syncwarp();
    if (c0 == 0) k2::store_u<G>(Us, s, rw);
    __syncthreads();   // U whole
    if (live) k2::dkrel_product<G, DKP>(acc, Qb, Us, md0, cw0);
    __syncthreads();   // the buffer, the band and U are reused next
    if (NB == 1 && it + 1 < items) stage_item(it + 1);
  }
  // the window's partial: (DKP, 2T) float32 at (k, delta, g); in the
  // cluster body (n DKP, 2T), the warp's rows from sl.gw
  constexpr int WC = W::kCols;
  if constexpr (CL) {
    float* out = part + (((size_t)kk * n_qt + delta) * gridDim.y + g) *
                            cta.n * DKP * WC;
#pragma unroll
    for (int a = 0; a < DS::kWD; ++a)
#pragma unroll
      for (int b = 0; b < DS::kWC; ++b)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int dl = a * 16 + k5::row_of(2 * h);   // the warp's row
          const int col = (cw0 + b) * 8 + ((threadIdx.x & 3) << 1);
          if (dl < sl.live)
            *reinterpret_cast<float2*>(out + (size_t)(sl.gw + dl) * WC +
                                       col) =
                make_float2(acc[a][b][2 * h], acc[a][b][2 * h + 1]);
        }
  } else {
    float* out =
        part + (((size_t)kk * n_qt + delta) * gridDim.y + g) * DKP * WC;
#pragma unroll
    for (int a = 0; a < DS::kWD; ++a)
#pragma unroll
      for (int b = 0; b < DS::kWC; ++b)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int d = (md0 + a) * 16 + k5::row_of(2 * h);
          const int col = (cw0 + b) * 8 + ((threadIdx.x & 3) << 1);
          *reinterpret_cast<float2*>(out + (size_t)d * WC + col) =
              make_float2(acc[a][b][2 * h], acc[a][b][2 * h + 1]);
        }
  }
  if (armed) k2::cluster_wait();   // the cluster has read the block
}

// dkrel[k][d][r] = the sum of the partial windows (k, delta, g) that hold
// column r (window delta starts at S - (delta + 1) T), over delta, then g,
// in that order.
__global__ void dkrel_windows_reduce(const float* __restrict__ part,
                                     float* __restrict__ dkrel, int K,
                                     int dk, int S, int dkp, int T, int n_qt,
                                     int n_groups) {
  const size_t n = (size_t)K * dk * S;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    const int r = (int)(e % S), d = (int)(e / S % dk);
    const int kk = (int)(e / ((size_t)S * dk));
    float sum = 0.0f;
    for (int delta = 0; delta < n_qt; ++delta) {
      const int c = r - (S - (delta + 1) * T);
      if (c < 0 || c >= 2 * T) continue;
      const float* p = part + (((size_t)kk * n_qt + delta) * n_groups) *
                                  dkp * 2 * T + (size_t)d * 2 * T + c;
      for (int g = 0; g < n_groups; ++g)
        sum += p[(size_t)g * dkp * 2 * T];
    }
    dkrel[e] = sum;
  }
}

// The tile rows T of the backward at (dk, dtype) (K5's Geom; 16 in the
// cluster body).
int tile_of(int dk, int dtype) {
  const int dkp = k2::padded_width(dk);
  return dkp > 256 ? 16
         : (dtype == cpc::kFloat32 ? kF32Planes : 1) * dkp <= 128 ? 64
                                                                  : 32;
}

// (n_groups, group): the heads of a k in groups so that the diagonal
// pass's blocks come near kDiagBlocks.
void diag_groups(int K, int heads, int n_qt, int& n_groups, int& group) {
  int want = (kDiagBlocks + K * n_qt - 1) / (K * n_qt);
  want = want < 1 ? 1 : want > heads ? heads : want;
  group = (heads + want - 1) / want;
  n_groups = (heads + group - 1) / group;
}

struct Scratch {
  k2::Prep prep;
  size_t stats_bytes, part_bytes;
  int T, n_qt, n_groups, group;

  Scratch(int K, int n_batch, int S, int nheads, int dk, int dtype)
      : prep(K, K * n_batch * nheads, S, dk, dtype, 4, kF32Planes) {
    T = tile_of(dk, dtype);
    n_qt = (S + T - 1) / T;
    diag_groups(K, n_batch * nheads, n_qt, n_groups, group);
    stats_bytes = k2::round256((size_t)3 * K * n_batch * nheads * S *
                               sizeof(float));
    part_bytes = k2::round256((size_t)K * n_qt * n_groups *
                              k2::padded_width(dk) * 2 * T *
                              sizeof(float));
  }
  size_t bytes() const { return stats_bytes + part_bytes + prep.bytes(); }
};

template <typename T, int DKP>
int launch(const k2::Heads& H, const bf16* krp, const Scratch& sc, void* dq,
           void* dk_out, void* dv, float* dkrel, float* stats, float* part,
           int K, cpc::Dropout drop, cudaStream_t stream) {
  using C = Bwd<T, DKP>;
  using G = typename C::G;
  static_assert(G::kTile == 64 || G::kTile == 32 || G::kTile == 16,
                "tiles");
  if (sc.T != G::kTile) return (int)cudaErrorInvalidValue;
  auto rows = relpos_tc_bwd_rows<T, DKP>;
  auto cols = relpos_tc_bwd_cols<T, DKP>;
  auto diag = relpos_tc_bwd_diag<T, DKP>;
  const size_t s1 = rows_bytes<T, DKP>(C::kRowBufs);
  const size_t s2 = cols_bytes<T, DKP>(C::kColBufs);
  const size_t s3 = diag_bytes<T, DKP>(C::kDiagBufs);
  cudaError_t err = cpc::allow_smem(rows, s1);
  if (err == cudaSuccess) err = cpc::allow_smem(cols, s2);
  if (err == cudaSuccess) err = cpc::allow_smem(diag, s3);
  if (err != cudaSuccess) return (int)err;
  const float inv_sqrt = 1.0f / sqrtf(static_cast<float>(H.dk));
  const int N = K * H.n_batch * H.nheads;
  const dim3 grid(N, sc.n_qt);
  rows<<<grid, k5::kThreads, s1, stream>>>(H, krp, sc.prep.sk,
                                           static_cast<T*>(dq), stats, N,
                                           inv_sqrt, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cols<<<grid, k5::kThreads, s2, stream>>>(
      H, krp, sc.prep.sk, static_cast<T*>(dk_out), static_cast<T*>(dv),
      stats, N, inv_sqrt, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  diag<<<dim3(sc.n_qt, sc.n_groups, K), k5::kThreads, s3, stream>>>(
      H, krp, sc.prep.sk, part, stats, N, sc.group, inv_sqrt, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)K * H.dk * H.S;
  dkrel_windows_reduce<<<k2::grid_of(n), 256, 0, stream>>>(
      part, dkrel, K, H.dk, H.S, DKP, G::kTile, sc.n_qt, sc.n_groups);
  return (int)cudaGetLastError();
}

// The cluster body: DKP 512's kernels on clusters of ceil(dk / 512) CTAs,
// the diagonal pass's partial windows (dkr, 2T) with dkr the padded width.
template <typename T>
int launch_cluster(const k2::Heads& H, const bf16* krp, const Scratch& sc,
                   void* dq, void* dk_out, void* dv, float* dkrel,
                   float* stats, float* part, int K, cpc::Dropout drop,
                   cudaStream_t stream) {
  constexpr int DKP = k2::kSlab;
  using C = Bwd<T, DKP, true>;
  using G = typename C::G;
  if (sc.T != G::kTile) return (int)cudaErrorInvalidValue;
  const int nc = k2::cluster_ctas(H.dk);
  const float inv_sqrt = 1.0f / sqrtf(static_cast<float>(H.dk));
  const int N = K * H.n_batch * H.nheads;
  const dim3 grid(N * nc, sc.n_qt);
  cudaError_t err = k2::launch_cluster(
      relpos_tc_bwd_rows<T, DKP, true>, grid, nc,
      rows_bytes<T, DKP, true>(C::kRowBufs), stream, H, krp, sc.prep.sk,
      static_cast<T*>(dq), stats, N, inv_sqrt, drop);
  if (err == cudaSuccess)
    err = k2::launch_cluster(
        relpos_tc_bwd_cols<T, DKP, true>, grid, nc,
        cols_bytes<T, DKP, true>(C::kColBufs), stream, H, krp, sc.prep.sk,
        static_cast<T*>(dk_out), static_cast<T*>(dv),
        static_cast<const float*>(stats), N, inv_sqrt, drop);
  if (err == cudaSuccess)
    err = k2::launch_cluster(
        relpos_tc_bwd_diag<T, DKP, true>, dim3(sc.n_qt * nc, sc.n_groups, K),
        nc, diag_bytes<T, DKP, true>(C::kDiagBufs), stream, H, krp,
        sc.prep.sk, part, static_cast<const float*>(stats), N, sc.group,
        inv_sqrt, drop);
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)K * H.dk * H.S;
  dkrel_windows_reduce<<<k2::grid_of(n), 256, 0, stream>>>(
      part, dkrel, K, H.dk, H.S, k2::padded_width(H.dk), G::kTile, sc.n_qt,
      sc.n_groups);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_any(const k2::Heads& H, const bf16* krp, const Scratch& sc,
               void* dq, void* dk_out, void* dv, float* dkrel, float* stats,
               float* part, int K, cpc::Dropout drop, cudaStream_t s) {
  if (H.dk > k2::kSlab)
    return launch_cluster<T>(H, krp, sc, dq, dk_out, dv, dkrel, stats, part,
                             K, drop, s);
  switch (k5::padded_dk(H.dk)) {
    case 32:
      return launch<T, 32>(H, krp, sc, dq, dk_out, dv, dkrel, stats, part,
                           K, drop, s);
    case 64:
      return launch<T, 64>(H, krp, sc, dq, dk_out, dv, dkrel, stats, part,
                           K, drop, s);
    case 128:
      return launch<T, 128>(H, krp, sc, dq, dk_out, dv, dkrel, stats, part,
                            K, drop, s);
    case 256:
      return launch<T, 256>(H, krp, sc, dq, dk_out, dv, dkrel, stats, part,
                            K, drop, s);
    default:
      return launch<T, 512>(H, krp, sc, dq, dk_out, dv, dkrel, stats, part,
                            K, drop, s);
  }
}

}  // namespace

// The body the backward runs at (S, dk), as the forward's: 1 the
// tensor-core tiles, 2 the cluster body, 0 refused.
extern "C" int cpc_relpos_attention_bwd_body(int S, int dk, int dtype) {
  (void)dtype;
  return !k2::takes(S, dk) ? 0 : dk <= k2::kSlab ? 1 : 2;
}

// Bytes of scratch the tensor-core backward needs: the rows' statistics
// (3, N, S), the diagonal pass's partial windows (K, n_qt, groups, dkp,
// 2T) float32 (dkp the padded width), krel's padded planes and, in
// float32, the two planes of q, k, v and do by head.
extern "C" size_t cpc_relpos_attention_bwd_tc_scratch(int K, int n_batch,
                                                      int S, int nheads,
                                                      int dk, int dtype) {
  return Scratch(K, n_batch, S, nheads, dk, dtype).bytes();
}

// q, k, v, dout and dq, dk, dv (K, n_batch*S, nheads*dk), krel (K, dk, S)
// in `dtype`; dkrel (K, dk, S) float32; scratch of
// cpc_relpos_attention_bwd_tc_scratch bytes, 256-byte aligned.
extern "C" int cpc_relpos_attention_bwd_tc(
    const void* q, const void* k, const void* v, const void* krel,
    const void* dout, void* dq, void* dk, void* dv, void* dkrel,
    void* scratch, int K, int n_batch, int S, int nheads, int dkh,
    const void* seed, unsigned int threshold, float keep_scale, int dtype,
    void* stream) {
  if (K <= 0 || K > 65535 || n_batch <= 0 || nheads <= 0 ||
      scratch == nullptr ||
      cpc_relpos_attention_bwd_body(S, dkh, dtype) == 0 ||
      (dtype != cpc::kFloat32 && dtype != cpc::kBFloat16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cpc::Dropout drop{static_cast<const int64_t*>(seed), threshold,
                          keep_scale};
  const Scratch sc(K, n_batch, S, nheads, dkh, dtype);
  char* base = static_cast<char*>(scratch);
  float* stats = reinterpret_cast<float*>(base);
  float* part = reinterpret_cast<float*>(base + sc.stats_bytes);
  void* prep = base + sc.stats_bytes + sc.part_bytes;
  const void* ops[4] = {q, k, v, dout};
  k2::Heads H{};
  const bf16* krp = nullptr;
  cudaError_t err =
      dtype == cpc::kFloat32
          ? k2::prepare<float>(sc.prep, krel, ops, 4, prep, K, n_batch, S,
                               nheads, dkh, H, krp, s)
          : k2::prepare<bf16>(sc.prep, krel, ops, 4, prep, K, n_batch, S,
                              nheads, dkh, H, krp, s);
  if (err != cudaSuccess) return (int)err;
  float* dr = static_cast<float*>(dkrel);
  return dtype == cpc::kFloat32
             ? launch_any<float>(H, krp, sc, dq, dk, dv, dr, stats, part, K,
                                 drop, s)
             : launch_any<bf16>(H, krp, sc, dq, dk, dv, dr, stats, part, K,
                                drop, s);
}
