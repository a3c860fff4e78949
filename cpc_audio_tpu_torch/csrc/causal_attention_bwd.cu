// K5 backward: causal attention with a dense bias (the transformer AR).
//
// Replaces cpc_audio_tpu/ops/pallas/attention.py `_bwd_kernel` (called
// through `_fused_bwd`).  Recompute-style: per row n of N = B * nheads the
// probabilities p are recomputed from q, k and the bias, and with the
// forward's dropout factors r (regenerated from dropout.cuh, keyed on
// (layer, n, i * S + j)):
//   dv_j    = sum_i p_ij r_ij do_i
//   dp_ij   = (do_i . v_j) r_ij,   ds_ij = p_ij (dp_ij - sum_j p_ij dp_ij) / sqrt(dk)
//   dq_i    = sum_j ds_ij k_j,     dk_j = sum_i ds_ij q_i,   dbias_ij = ds_ij
// all in float32 until the outputs are written in the input dtype, as the
// Pallas kernel does.  dbias is written in full: exactly 0 wherever
// j > i.  The caller builds the Shaw bias by the zero-pad/reshape skew,
// whose masked cells hold q . Krelpos values of other positions, so any
// other value there would flow into dq and dKrelpos.  No atomics: every
// output element is written by one thread, and every run gives the same
// bits.  Shapes: dk <= 512, a multiple of 8 in bf16; any S (64-bit
// offsets into the (N, S, S) bias and dbias).
//
// One tensor-core body for both dtypes (causal_attention.cuh): two
// kernels, each with blocks of 4 warps over tiles of 64 rows (32 past DKP
// 128 in bf16, 64 in float32; 16 at DKP 512), and cp.async staging.  It holds no (S, S)
// tile anywhere: its scratch is the rows' statistics (3, N, S) and, in
// float32, the bf16 planes of q, k, v and do (`split_operands`), so S is
// bounded by nothing but the caller's (N, S, S) bias.  49-51 KB of shared
// memory a block at dk <= 32 in bf16 (four blocks an SM, so the 512
// blocks of either kernel at N = 256, S = 128 run in one wave), 98-100 KB
// in float32, 214 KB at float32 DKP 256, 198 KB at float32 DKP 512.
//   1. `causal_attention_bwd_rows`, one block per (query tile, n): a
//      first pass over the key tiles up to the diagonal forms s = q.k^T
//      and dp = do.v^T on mma.sync and keeps, per query row, the running
//      max m, the sum l and c = sum_j p_ij dp_ij (rescaled as m moves); a
//      second pass recomputes p = exp(s - m) / l and ds, and accumulates
//      dq = ds . k.  It writes dq and the per-row (m, 1/l, c) as float32
//      scratch (3, N, S).  Where the first two key tiles are all the
//      tiles, they are still in the double buffer for the second pass.
//   2. `causal_attention_bwd_cols`, one block per (key tile, n), the
//      FlashAttention-2 order: the block's k and v stay in shared memory
//      while the query tiles at or below the diagonal stream through
//      (q, do, the bias chunk and the rows' statistics, double-buffered).
//      Each warp forms s^T = k.q^T and dp^T = v.do^T for its 16 keys, so
//      p^T r and ds^T sit in registers as the A operands of dv += (p r)^T
//      . do and dk += ds^T . q; ds goes through the bias chunk's own shared
//      tile to dbias in 16-byte row stores, and the block writes the zeros
//      of dbias above its diagonal.  The dropout bits are drawn once per
//      pair in each kernel (the row kernel keeps them in registers between
//      its passes where the first two key tiles are all).
// Past 64-row tiles, the two warps of a pair form the same 16 rows'
// scores, and each accumulates half of the output columns (dq; dk and
// dv); one of them writes the statistics and the dbias tile.  At DKP 512
// all four warps share the 16 rows and accumulate a quarter of the
// columns each, and each forms s and dp (s^T and dp^T in the column
// kernel) over its quarter of dk only: the partial tiles are summed w 0 +
// 1 + 2 + 3 through 8 KB of shared memory (causal_attention.cuh
// `kSplitK`), one more __syncthreads a key (query) tile.
// The Pallas kernel multiplies p r and ds unrounded in float32; a bf16
// operand would keep 8 of their bits, so those three products (dq, dk, dv)
// take each operand as the two-term split hi = bf16(x), lo = bf16(x - hi)
// and two mma.sync, carrying about 16 bits.  In bf16, q, k, v and do are
// bf16 already, so q.k^T and do.v^T are exact in float32; in float32 both
// take their operands' planes, as do the other sides of dq, dk and dv:
// three split products each, within 10 % of chip_smoke's float32
// tolerance (ops/causal_attention.py `causal_attention_bwd_split`).
//
// What bounds it on an H100: at N = 256, S = 128, dk = 32 the call moves
// 31.5 MB in bf16 (dbias written whole is 8.4 MB) for 0.67 GFLOP of causal
// products: memory, 9.4 us at 3.35 TB/s; the row kernel's 1.2 MB of
// statistics and its second read of q, k, v, do and the bias chunks (from
// L2) come on top.  Float32 moves twice the bytes, plus the planes.
#include "causal_attention.cuh"

namespace {

using cpc::k5::bf16;
namespace k5 = cpc::k5;

// ---------------------------------------------------------------------------
// kernel 1: by query tile -> dq and the rows' statistics
// ---------------------------------------------------------------------------

// Floats of the kSplitK partials of s and dp (none elsewhere).
template <typename G>
constexpr int kRedFloats = G::kSplitK ? 2 * k5::kPartialFloats<G::kNT> : 0;

template <typename T, int DKP>
constexpr size_t rows_smem_bytes() {
  using G = k5::Geom<T, DKP>;
  // q, do, two (k, v) buffers (bf16 planes), two bias buffers (T); the
  // partials
  return (size_t)6 * G::kTileElems * sizeof(bf16) +
         (size_t)2 * G::kBiasElems * sizeof(T) +
         kRedFloats<G> * sizeof(float);
}

// The warp's scores s (scaled, bias added, -inf above the diagonal) for
// key tile kt of query tile q0, from the raw products; returns nothing
// else: the same code serves both passes, so both see the same bits.
template <typename G, typename T>
__device__ __forceinline__ void scale_mask(float s[G::kNT][4], const T* Bb,
                                           int rw, int q0, int kt,
                                           float inv_sqrt) {
#pragma unroll
  for (int nt = 0; nt < G::kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ri = rw * 16 + k5::row_of(e), cj = k5::col_of(nt, e);
      const int i = q0 + ri, j = kt * G::kTile + cj;
      s[nt][e] = j <= i ? (s[nt][e] +
                           cpc::to_f32(Bb[ri * G::kLdb + cj])) *
                              inv_sqrt
                        : -INFINITY;
    }
}

// q, k, v, dout: the bf16 operands as they are (rows `lds` = dk apart) or
// the float32 operands' planes (lds = DKP, `plane` elements apart).
template <typename T, int DKP>
__global__ void __launch_bounds__(k5::kThreads,
                                  (k5::Geom<T, DKP>::kMinBlocks))
    causal_attention_bwd_rows(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const T* __restrict__ bias,
    const bf16* __restrict__ dout, T* __restrict__ dq,
    float* __restrict__ stats, int N, int S, int dk, int lds, size_t plane,
    float inv_sqrt, uint32_t w1_base, cpc::Dropout drop) {
  using G = k5::Geom<T, DKP>;
  constexpr int TE = G::kTileElems;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ds = Qs + TE;              // do
  bf16* Ks = Ds + TE;              // 2 buffers
  bf16* Vs = Ks + 2 * TE;          // 2 buffers
  T* Bs = reinterpret_cast<T*>(Vs + 2 * TE);   // 2 buffers of (kTile, kLdb)
  float* Red = reinterpret_cast<float*>(Bs + 2 * G::kBiasElems);  // kSplitK

  const int n = blockIdx.y;
  const int qt = gridDim.x - 1 - blockIdx.x;   // longest rows first
  const int q0 = qt * G::kTile;
  const size_t base = (size_t)n * S * lds;
  const T* bias_n = bias + (size_t)n * S * S;
  const int warp = threadIdx.x >> 5;
  const int rw = warp % G::kRowWarps;
  const int c0 = warp / G::kRowWarps * G::kDV;
  const int r0 = q0 + rw * 16;
  const uint32_t row_key =
      drop.active() ? cpc::dropout_row_key(drop.seed_word(),
                                           cpc::kSiteARAttention,
                                           w1_base + (uint32_t)n)
                    : 0u;
  auto stage_tile = [&](int kt) {   // key tile kt into buffer kt & 1
    const int b = kt & 1, k0 = kt * G::kTile;
    k5::stage_rows<G, DKP>(Ks + b * TE, k + base, plane, k0, S, lds, lds);
    k5::stage_rows<G, DKP>(Vs + b * TE, v + base, plane, k0, S, lds, lds);
    k5::stage_bias<G>(Bs + b * G::kBiasElems, bias_n, q0, k0, S);
    cpc::mma::cp_async_commit();
  };

  k5::stage_rows<G, DKP>(Qs, q + base, plane, q0, S, lds, lds);
  k5::stage_rows<G, DKP>(Ds, dout + base, plane, q0, S, lds, lds);
  stage_tile(0);

  // ---- pass 1: m, l and c = sum_j p dp, online over the key tiles ----
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f},
        c[2] = {0.0f, 0.0f};
  uint32_t keep01[2] = {0u, 0u};   // key tiles 0, 1: reused by pass 2
  for (int kt = 0; kt <= qt; ++kt) {
    const int buf = kt & 1;
    // the dropout bits need no data: drawn while the tile is in flight
    const int n_hi = kt == qt ? 2 * rw + 2 : G::kNT;
    const uint32_t keep =
        k5::keep_bits<G>(drop, row_key, r0, kt * G::kTile, 0, n_hi, S);
    if (kt == 0) keep01[0] = keep;
    if (kt == 1) keep01[1] = keep;
    if (kt < qt) {
      stage_tile(kt + 1);
      cpc::mma::cp_async_wait<1>();
    } else {
      cpc::mma::cp_async_wait<0>();
    }
    __syncthreads();
    float s[G::kNT][4], dp[G::kNT][4];
    if constexpr (G::kSplitK) {
      k5::split_products<G>(s, dp, Qs, Ks + buf * TE, Ds, Vs + buf * TE, 0,
                            n_hi, c0, Red);
    } else {
      k5::rows_dot_rows<G, DKP>(s, Qs, rw * 16, Ks + buf * TE, 0, n_hi);
      k5::rows_dot_rows<G, DKP>(dp, Ds, rw * 16, Vs + buf * TE, 0, n_hi);
    }
    scale_mask<G>(s, Bs + buf * G::kBiasElems, rw, q0, kt, inv_sqrt);
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
    __syncthreads();
  }
  float inv_l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    inv_l[h] = 1.0f / l[h];
    c[h] *= inv_l[h];
  }

  // ---- pass 2: p, ds; dq += ds . k ----
  const bool resident = qt <= 1;   // both key tiles still in the buffers
  if (!resident) stage_tile(0);
  float dqa[G::kDV / 8][4];
#pragma unroll
  for (int nt = 0; nt < G::kDV / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[nt][e] = 0.0f;
  for (int kt = 0; kt <= qt; ++kt) {
    const int buf = kt & 1;
    const int n_hi = kt == qt ? 2 * rw + 2 : G::kNT;
    const uint32_t keep =
        resident ? (kt == 0 ? keep01[0] : keep01[1])
                 : k5::keep_bits<G>(drop, row_key, r0, kt * G::kTile, 0,
                                    n_hi, S);
    if (!resident) {
      if (kt < qt) {
        stage_tile(kt + 1);
        cpc::mma::cp_async_wait<1>();
      } else {
        cpc::mma::cp_async_wait<0>();
      }
      __syncthreads();
    }
    float s[G::kNT][4], dp[G::kNT][4];
    if constexpr (G::kSplitK) {
      k5::split_products<G>(s, dp, Qs, Ks + buf * TE, Ds, Vs + buf * TE, 0,
                            n_hi, c0, Red);
    } else {
      k5::rows_dot_rows<G, DKP>(s, Qs, rw * 16, Ks + buf * TE, 0, n_hi);
      k5::rows_dot_rows<G, DKP>(dp, Ds, rw * 16, Vs + buf * TE, 0, n_hi);
    }
    scale_mask<G>(s, Bs + buf * G::kBiasElems, rw, q0, kt, inv_sqrt);
#pragma unroll
    for (int nt = 0; nt < G::kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float p = expf(s[nt][e] - m[h]) * inv_l[h];
        const float r = k5::kept_factor(drop, keep, nt, e);
        s[nt][e] = p * (dp[nt][e] * r - c[h]) * inv_sqrt;
      }
    k5::acc_times_rows<G, true>(dqa, s, Ks + buf * TE + c0, 0, n_hi / 2);
    // the buffers are restaged, or (kSplitK) Red is stored again, next
    if constexpr (G::kSplitK)
      __syncthreads();
    else if (!resident)
      __syncthreads();
  }
  const float one[2] = {1.0f, 1.0f};
  k5::store_rows<G>(dq + (size_t)n * S * dk, dqa, r0, c0, S, dk, one);
  if (c0 == 0 && (threadIdx.x & 3) == 0) {
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
}

// ---------------------------------------------------------------------------
// kernel 2: by key tile -> dk, dv and dbias
// ---------------------------------------------------------------------------

template <typename T, int DKP>
constexpr size_t cols_smem_bytes() {
  using G = k5::Geom<T, DKP>;
  // k, v; two (q, do) buffers; two bias buffers (each, once read, also the
  // tile's ds on its way to dbias); two statistics buffers of (m, 1/l, c):
  // 50.7 KB at dk <= 32 in bf16, four blocks an SM; the partials
  return (size_t)6 * G::kTileElems * sizeof(bf16) +
         (size_t)2 * G::kBiasElems * sizeof(T) +
         (size_t)2 * 3 * G::kTile * sizeof(float) +
         kRedFloats<G> * sizeof(float);
}

template <typename T, int DKP>
__global__ void __launch_bounds__(k5::kThreads,
                                  (k5::Geom<T, DKP>::kMinBlocks))
    causal_attention_bwd_cols(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const T* __restrict__ bias,
    const bf16* __restrict__ dout, T* __restrict__ dk_out,
    T* __restrict__ dv, T* __restrict__ dbias,
    const float* __restrict__ stats, int N, int S, int dk, int lds,
    size_t plane, float inv_sqrt, uint32_t w1_base, cpc::Dropout drop) {
  using G = k5::Geom<T, DKP>;
  constexpr int TE = G::kTileElems;
  constexpr int kStats = 3 * G::kTile;   // (m, 1/l, c) of a query tile
  constexpr int E = 16 / sizeof(T);      // dbias elements a 16-byte store
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + TE;
  bf16* Qs = Vs + TE;              // 2 buffers
  bf16* Ds = Qs + 2 * TE;          // 2 buffers of do
  T* Bs = reinterpret_cast<T*>(Ds + 2 * TE);   // 2 buffers of (kTile, kLdb)
  float* St = reinterpret_cast<float*>(Bs + 2 * G::kBiasElems);  // 2 x kStats
  float* Red = St + 2 * kStats;    // kSplitK

  const int n = blockIdx.y;
  const int kt = blockIdx.x;       // most query tiles first
  const int k0 = kt * G::kTile;
  const int n_qt = gridDim.x;
  const size_t base = (size_t)n * S * lds;
  const T* bias_n = bias + (size_t)n * S * S;
  T* dbias_n = dbias + (size_t)n * S * S;
  const int warp = threadIdx.x >> 5;
  const int rw = warp % G::kRowWarps;
  const int c0 = warp / G::kRowWarps * G::kDV;
  const bool rows16 = S % E == 0;   // dbias rows 16-byte aligned
  const uint32_t row_key =
      drop.active() ? cpc::dropout_row_key(drop.seed_word(),
                                           cpc::kSiteARAttention,
                                           w1_base + (uint32_t)n)
                    : 0u;
  auto stage_tile = [&](int qt) {   // query tile qt into buffer (qt-kt) & 1
    const int b = (qt - kt) & 1, q0 = qt * G::kTile;
    k5::stage_rows<G, DKP>(Qs + b * TE, q + base, plane, q0, S, lds, lds);
    k5::stage_rows<G, DKP>(Ds + b * TE, dout + base, plane, q0, S, lds, lds);
    k5::stage_bias<G>(Bs + b * G::kBiasElems, bias_n, q0, k0, S);
    float* st = St + b * kStats;
    for (int idx = threadIdx.x; idx < kStats; idx += k5::kThreads) {
      const int a = idx / G::kTile, i = q0 + idx % G::kTile;
      if (i < S)
        cpc::mma::cp_async4(st + idx, stats + (a * (size_t)N + n) * S + i);
    }
    cpc::mma::cp_async_commit();
  };

  k5::stage_rows<G, DKP>(Ks, k + base, plane, k0, S, lds, lds);
  k5::stage_rows<G, DKP>(Vs, v + base, plane, k0, S, lds, lds);
  stage_tile(kt);

  // dbias above this block's diagonal: rows [0, k0), columns [k0, k0 +
  // kTile)
  const int n_cols = min(G::kTile, S - k0);
  if (rows16) {
    constexpr int C = G::kTile / E;
    for (int idx = threadIdx.x; idx < k0 * C; idx += k5::kThreads) {
      const int r = idx / C, c = (idx % C) * E;
      if (c < n_cols)
        *reinterpret_cast<uint4*>(dbias_n + (size_t)r * S + k0 + c) =
            make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int idx = threadIdx.x; idx < k0 * G::kTile; idx += k5::kThreads) {
      const int r = idx / G::kTile, c = idx % G::kTile;
      if (c < n_cols)
        dbias_n[(size_t)r * S + k0 + c] = cpc::from_f32<T>(0.0f);
    }
  }

  float dka[G::kDV / 8][4], dva[G::kDV / 8][4];
#pragma unroll
  for (int nt = 0; nt < G::kDV / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[nt][e] = dva[nt][e] = 0.0f;

  for (int qt = kt; qt < n_qt; ++qt) {
    const int buf = (qt - kt) & 1;
    const int q0 = qt * G::kTile;
    // on the diagonal tile, query n8 tiles before the warp's keys are
    // all masked; the dropout bits need no data: drawn while the tile is
    // in flight
    const int n_lo = qt == kt ? 2 * rw : 0;
    const uint32_t keep = k5::keep_bits<G, true>(drop, row_key,
                                                 k0 + rw * 16, q0, n_lo,
                                                 G::kNT, S);
    if (qt + 1 < n_qt) {
      stage_tile(qt + 1);
      cpc::mma::cp_async_wait<1>();
    } else {
      cpc::mma::cp_async_wait<0>();
    }
    __syncthreads();
    float st[G::kNT][4], dpt[G::kNT][4];   // (16 keys, kTile queries)
    if constexpr (G::kSplitK) {
      k5::split_products<G>(st, dpt, Ks, Qs + buf * TE, Vs, Ds + buf * TE,
                            n_lo, G::kNT, c0, Red);
    } else {
      k5::rows_dot_rows<G, DKP>(st, Ks, rw * 16, Qs + buf * TE, n_lo,
                                G::kNT);
      k5::rows_dot_rows<G, DKP>(dpt, Vs, rw * 16, Ds + buf * TE, n_lo,
                                G::kNT);
    }
    // the bias chunk; once read, each element is overwritten with its ds:
    // the (kTile queries, kLdb) dbias tile
    T* DB = Bs + buf * G::kBiasElems;
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
              (st[nt][e] + cpc::to_f32(DB[il * G::kLdb + jl])) * inv_sqrt;
          const float p = expf(x - sm[il]) * sm[G::kTile + il];
          const float r = k5::kept_factor(drop, keep, nt, e);
          pd = p * r;
          ds = p * (dpt[nt][e] * r - sm[2 * G::kTile + il]) * inv_sqrt;
        }
        st[nt][e] = pd;
        dpt[nt][e] = ds;
        if constexpr (G::kColWarps == 1)
          DB[il * G::kLdb + jl] = cpc::from_f32<T>(ds);
      }
    if constexpr (G::kColWarps > 1) {
      // the pair's other warp reads the same bias elements: all reads
      // before the first warp of each pair overwrites them
      __syncthreads();
      if (c0 == 0) {
#pragma unroll
        for (int nt = 0; nt < G::kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            DB[k5::col_of(nt, e) * G::kLdb + rw * 16 + k5::row_of(e)] =
                cpc::from_f32<T>(dpt[nt][e]);
      }
    }
    k5::acc_times_rows<G, true>(dva, st, Ds + buf * TE + c0, n_lo / 2,
                                G::kNT / 2);
    k5::acc_times_rows<G, true>(dka, dpt, Qs + buf * TE + c0, n_lo / 2,
                                G::kNT / 2);
    __syncthreads();   // DB is whole; buffer `buf` is free
    const int n_rows = min(G::kTile, S - q0);
    if (rows16) {
      constexpr int C = G::kTile / E;
      for (int idx = threadIdx.x; idx < G::kTile * C; idx += k5::kThreads) {
        const int r = idx / C, c = (idx % C) * E;
        if (r < n_rows && c < n_cols)
          *reinterpret_cast<uint4*>(dbias_n + (size_t)(q0 + r) * S + k0 + c) =
              *reinterpret_cast<const uint4*>(DB + r * G::kLdb + c);
      }
    } else {
      for (int idx = threadIdx.x; idx < G::kTile * G::kTile;
           idx += k5::kThreads) {
        const int r = idx / G::kTile, c = idx % G::kTile;
        if (r < n_rows && c < n_cols)
          dbias_n[(size_t)(q0 + r) * S + k0 + c] = DB[r * G::kLdb + c];
      }
    }
    __syncthreads();   // the next iteration restages this buffer
  }
  const float one[2] = {1.0f, 1.0f};
  const size_t out = (size_t)n * S * dk;
  k5::store_rows<G>(dk_out + out, dka, k0 + rw * 16, c0, S, dk, one);
  k5::store_rows<G>(dv + out, dva, k0 + rw * 16, c0, S, dk, one);
}

template <typename T, int DKP>
int launch(const bf16* q, const bf16* k, const bf16* v, const void* bias,
           const bf16* dout, void* dq, void* dk_out, void* dv, void* dbias,
           float* stats, int N, int S, int dk, int lds, size_t plane,
           int layer, cpc::Dropout drop, cudaStream_t stream) {
  using G = k5::Geom<T, DKP>;
  auto rows = causal_attention_bwd_rows<T, DKP>;
  auto cols = causal_attention_bwd_cols<T, DKP>;
  const size_t s1 = rows_smem_bytes<T, DKP>(), s2 = cols_smem_bytes<T, DKP>();
  cudaError_t err = cpc::allow_smem(rows, s1);
  if (err != cudaSuccess) return (int)err;
  err = cpc::allow_smem(cols, s2);
  if (err != cudaSuccess) return (int)err;
  const float inv_sqrt = 1.0f / sqrtf(static_cast<float>(dk));
  const uint32_t w1_base = (uint32_t)layer * (uint32_t)N;
  const dim3 grid((S + G::kTile - 1) / G::kTile, N);
  const T* b = static_cast<const T*>(bias);
  rows<<<grid, k5::kThreads, s1, stream>>>(q, k, v, b, dout,
                                           static_cast<T*>(dq), stats, N, S,
                                           dk, lds, plane, inv_sqrt, w1_base,
                                           drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cols<<<grid, k5::kThreads, s2, stream>>>(
      q, k, v, b, dout, static_cast<T*>(dk_out), static_cast<T*>(dv),
      static_cast<T*>(dbias), stats, N, S, dk, lds, plane, inv_sqrt, w1_base,
      drop);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_any(const bf16* q, const bf16* k, const bf16* v, const void* bias,
               const bf16* dout, void* dq, void* dk_out, void* dv,
               void* dbias, float* stats, int N, int S, int dk, int lds,
               size_t plane, int layer, cpc::Dropout drop, cudaStream_t s) {
  switch (k5::padded_dk(dk)) {
    case 32:
      return launch<T, 32>(q, k, v, bias, dout, dq, dk_out, dv, dbias, stats,
                           N, S, dk, lds, plane, layer, drop, s);
    case 64:
      return launch<T, 64>(q, k, v, bias, dout, dq, dk_out, dv, dbias, stats,
                           N, S, dk, lds, plane, layer, drop, s);
    case 128:
      return launch<T, 128>(q, k, v, bias, dout, dq, dk_out, dv, dbias,
                            stats, N, S, dk, lds, plane, layer, drop, s);
    case 256:
      return launch<T, 256>(q, k, v, bias, dout, dq, dk_out, dv, dbias,
                            stats, N, S, dk, lds, plane, layer, drop, s);
    default:
      return launch<T, 512>(q, k, v, bias, dout, dq, dk_out, dv, dbias,
                            stats, N, S, dk, lds, plane, layer, drop, s);
  }
}

// The statistics' bytes, rounded up so that the planes after them stay
// 16-byte aligned.
size_t stats_bytes(int N, int S) {
  return ((size_t)3 * N * S * sizeof(float) + 255) / 256 * 256;
}

}  // namespace

// Bytes of scratch the backward needs: the rows' statistics (3, N, S)
// float32 and, in float32, the bf16 planes of q, k, v and do after them.
extern "C" size_t cpc_causal_attention_bwd_scratch(int N, int S, int dk,
                                                   int dtype) {
  return stats_bytes(N, S) +
         (dtype == cpc::kFloat32 ? k5::planes_bytes(4, 2, N, S, dk) : 0);
}

// q, k, v, dout and dq, dk, dv (N, S, dk), bias and dbias (N, S, S), all
// in `dtype`; scratch of cpc_causal_attention_bwd_scratch bytes, 16-byte
// aligned.  dk <= 512, in bf16 a multiple of 8 with 16-byte aligned rows.
extern "C" int cpc_causal_attention_bwd(
    const void* q, const void* k, const void* v, const void* bias,
    const void* dout, void* dq, void* dk, void* dv, void* dbias,
    void* scratch, int N, int S, int dkh, int layer, const void* seed,
    unsigned int threshold, float keep_scale, int dtype, void* stream) {
  if (N <= 0 || N > 65535 || S <= 0 || dkh <= 0 ||
      k5::padded_dk(dkh) == 0 || scratch == nullptr ||
      (dtype == cpc::kBFloat16 && dkh % 8 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cpc::Dropout drop{static_cast<const int64_t*>(seed), threshold,
                          keep_scale};
  float* stats = static_cast<float*>(scratch);
  if (dtype == cpc::kBFloat16)
    return launch_any<bf16>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), bias, static_cast<const bf16*>(dout),
        dq, dk, dv, dbias, stats, N, S, dkh, dkh, 0, layer, drop, s);
  if (dtype != cpc::kFloat32) return (int)cudaErrorInvalidValue;
  bf16* planes = reinterpret_cast<bf16*>(static_cast<char*>(scratch) +
                                         stats_bytes(N, S));
  const k5::Operands ops{{static_cast<const float*>(q),
                          static_cast<const float*>(k),
                          static_cast<const float*>(v),
                          static_cast<const float*>(dout)}};
  const cudaError_t err = k5::split(ops, 4, 2, planes, N * S, dkh, s);
  if (err != cudaSuccess) return (int)err;
  const int dkp = k5::padded_dk(dkh);
  const size_t plane = (size_t)N * S * dkp;    // elements, hi to lo
  return launch_any<float>(planes, planes + 2 * plane, planes + 4 * plane,
                           bias, planes + 6 * plane, dq, dk, dv, dbias,
                           stats, N, S, dkh, dkp, plane, layer, drop, s);
}
