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
// bits.  Shapes: dk <= 128, a multiple of 8 in bf16; any S (the gate
// keeps S <= 512).
//
// bf16 body (the train path): tensor cores, two kernels, each with blocks
// of 4 warps over 64-row tiles, 16 rows a warp, and cp.async staging
// (causal_attention.cuh).  It holds no (S, S) tile anywhere: 49-51 KB of
// shared memory a block at dk <= 32 (four blocks an SM, so the 512 blocks
// of either kernel at N = 256, S = 128 run in one wave).
//   1. `causal_attention_bwd_rows`, one block per (64-query tile, n): a
//      first pass over the key tiles up to the diagonal forms s = q.k^T
//      and dp = do.v^T on mma.sync and keeps, per query row, the running
//      max m, the sum l and c = sum_j p_ij dp_ij (rescaled as m moves); a
//      second pass recomputes p = exp(s - m) / l and ds, and accumulates
//      dq = ds . k.  It writes dq and the per-row (m, 1/l, c) as float32
//      scratch (3, N, S).  At S <= 128 the key tiles of the first pass are
//      still in the double buffer for the second.
//   2. `causal_attention_bwd_cols`, one block per (64-key tile, n), the
//      FlashAttention-2 order: the block's k and v stay in shared memory
//      while the query tiles at or below the diagonal stream through
//      (q, do, the bias chunk and the rows' statistics, double-buffered).
//      Each warp forms s^T = k.q^T and dp^T = v.do^T for its 16 keys, so
//      p^T r and ds^T sit in registers as the A operands of dv += (p r)^T
//      . do and dk += ds^T . q; ds goes through the bias chunk's own shared
//      tile to dbias in 16-byte row stores, and the block writes the zeros
//      of dbias above its diagonal.  The dropout bits are drawn once per
//      pair in each kernel (the row kernel keeps them in registers between
//      its passes at S <= 128).
// The Pallas kernel multiplies p r and ds unrounded in float32; a bf16
// operand would keep 8 of their bits, so those three products (dq, dk, dv)
// take each operand as the two-term split hi = bf16(x), lo = bf16(x - hi)
// and two mma.sync, carrying about 16 bits.  q, k, v and do are bf16
// already, so q.k^T and do.v^T are exact in float32.
//
// float32 body: exact FMA loops (TF32 would change the numbers), one block
// of 8 warps per n.  By query row each warp forms p, dp, ds (the dbias row
// and dq_i at once) and p r; then by key column dk_j and dv_j.  The (S, S)
// ds and p r tiles and the float32 q, do, k, v sit in shared memory where
// they fit (S = 128 at dk = 32); past that ds is kept in dbias itself
// (float32, the same values) and p r in a float32 scratch (N, S, S), and
// past the inputs' fit the loops read them in place.
//
// What bounds it on an H100: at N = 256, S = 128, dk = 32 the call moves
// 31.5 MB in bf16 (dbias written whole is 8.4 MB) for 0.67 GFLOP of causal
// products: memory, 9.4 us at 3.35 TB/s; the row kernel's 1.2 MB of
// statistics and its second read of q, k, v, do and the bias chunks (from
// L2) come on top.
#include "causal_attention.cuh"

namespace {

using cpc::k5::bf16;
namespace k5 = cpc::k5;

// ---------------------------------------------------------------------------
// bf16 body, kernel 1: by query tile -> dq and the rows' statistics
// ---------------------------------------------------------------------------

template <int DKP>
constexpr size_t rows_smem_bytes() {
  // q, do, two (k, v) buffers, two bias buffers
  return ((size_t)6 * k5::tile_elems<DKP>() + 2 * k5::bias_elems()) *
         sizeof(bf16);
}

// The warp's scores s (scaled, bias added, -inf above the diagonal) for
// key tile kt of query tile q0, from the raw products; returns nothing
// else: the same code serves both passes, so both see the same bits.
__device__ __forceinline__ void scale_mask(float s[8][4], const bf16* Bb,
                                           int warp, int q0, int kt,
                                           float inv_sqrt) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ri = warp * 16 + k5::row_of(e), cj = k5::col_of(nt, e);
      const int i = q0 + ri, j = kt * k5::kTile + cj;
      s[nt][e] = j <= i ? (s[nt][e] +
                           __bfloat162float(Bb[ri * k5::kLdb + cj])) *
                              inv_sqrt
                        : -INFINITY;
    }
}

template <int DKP>
__global__ void __launch_bounds__(k5::kThreads, k5::bwd_min_blocks<DKP>())
    causal_attention_bwd_rows(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ bias,
    const bf16* __restrict__ dout, bf16* __restrict__ dq,
    float* __restrict__ stats, int N, int S, int dk, float inv_sqrt,
    uint32_t w1_base, cpc::Dropout drop) {
  constexpr int TE = k5::tile_elems<DKP>();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ds = Qs + TE;              // do
  bf16* Ks = Ds + TE;              // 2 buffers
  bf16* Vs = Ks + 2 * TE;          // 2 buffers
  bf16* Bs = Vs + 2 * TE;          // 2 buffers of (64, kLdb)

  const int n = blockIdx.y;
  const int qt = gridDim.x - 1 - blockIdx.x;   // longest rows first
  const int q0 = qt * k5::kTile;
  const size_t base = (size_t)n * S * dk;
  const bf16* bias_n = bias + (size_t)n * S * S;
  const int warp = threadIdx.x >> 5;
  const int r0 = q0 + warp * 16;
  const uint32_t row_key =
      drop.active() ? cpc::dropout_row_key(drop.seed_word(),
                                           cpc::kSiteARAttention,
                                           w1_base + (uint32_t)n)
                    : 0u;
  auto stage_tile = [&](int kt) {   // key tile kt into buffer kt & 1
    const int b = kt & 1, k0 = kt * k5::kTile;
    k5::stage_rows<DKP>(Ks + b * TE, k + base, k0, S, dk);
    k5::stage_rows<DKP>(Vs + b * TE, v + base, k0, S, dk);
    k5::stage_bias(Bs + b * k5::bias_elems(), bias_n, q0, k0, S);
    cpc::mma::cp_async_commit();
  };

  k5::stage_rows<DKP>(Qs, q + base, q0, S, dk);
  k5::stage_rows<DKP>(Ds, dout + base, q0, S, dk);
  stage_tile(0);

  // ---- pass 1: m, l and c = sum_j p dp, online over the key tiles ----
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f},
        c[2] = {0.0f, 0.0f};
  uint32_t keep01[2] = {0u, 0u};   // key tiles 0, 1: reused by pass 2
  for (int kt = 0; kt <= qt; ++kt) {
    const int buf = kt & 1;
    // the dropout bits need no data: drawn while the tile is in flight
    const int n_hi = kt == qt ? 2 * warp + 2 : 8;
    const uint32_t keep =
        k5::keep_bits(drop, row_key, r0, kt * k5::kTile, 0, n_hi, S);
    if (kt == 0) keep01[0] = keep;
    if (kt == 1) keep01[1] = keep;
    if (kt < qt) {
      stage_tile(kt + 1);
      cpc::mma::cp_async_wait<1>();
    } else {
      cpc::mma::cp_async_wait<0>();
    }
    __syncthreads();
    float s[8][4], dp[8][4];
    k5::rows_dot_rows<DKP>(s, Qs, warp * 16, Ks + buf * TE, 0, n_hi);
    k5::rows_dot_rows<DKP>(dp, Ds, warp * 16, Vs + buf * TE, 0, n_hi);
    scale_mask(s, Bs + buf * k5::bias_elems(), warp, q0, kt, inv_sqrt);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
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
    for (int nt = 0; nt < 8; ++nt)
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
  float dqa[DKP / 8][4];
#pragma unroll
  for (int nt = 0; nt < DKP / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[nt][e] = 0.0f;
  for (int kt = 0; kt <= qt; ++kt) {
    const int buf = kt & 1;
    const int n_hi = kt == qt ? 2 * warp + 2 : 8;
    const uint32_t keep =
        resident ? (kt == 0 ? keep01[0] : keep01[1])
                 : k5::keep_bits(drop, row_key, r0, kt * k5::kTile, 0, n_hi,
                                 S);
    if (!resident) {
      if (kt < qt) {
        stage_tile(kt + 1);
        cpc::mma::cp_async_wait<1>();
      } else {
        cpc::mma::cp_async_wait<0>();
      }
      __syncthreads();
    }
    float s[8][4], dp[8][4];
    k5::rows_dot_rows<DKP>(s, Qs, warp * 16, Ks + buf * TE, 0, n_hi);
    k5::rows_dot_rows<DKP>(dp, Ds, warp * 16, Vs + buf * TE, 0, n_hi);
    scale_mask(s, Bs + buf * k5::bias_elems(), warp, q0, kt, inv_sqrt);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float p = expf(s[nt][e] - m[h]) * inv_l[h];
        const float r = k5::kept_factor(drop, keep, nt, e);
        s[nt][e] = p * (dp[nt][e] * r - c[h]) * inv_sqrt;
      }
    k5::acc_times_rows<DKP, true>(dqa, s, Ks + buf * TE, 0, n_hi / 2);
    if (!resident) __syncthreads();
  }
  const float one[2] = {1.0f, 1.0f};
  k5::store_rows<DKP>(dq + base, dqa, r0, S, dk, one);
  if ((threadIdx.x & 3) == 0) {
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
// bf16 body, kernel 2: by key tile -> dk, dv and dbias
// ---------------------------------------------------------------------------

constexpr int kStats = 3 * k5::kTile;   // (m, 1/l, c) of a query tile

template <int DKP>
constexpr size_t cols_smem_bytes() {
  // k, v; two (q, do) buffers; two bias buffers (each, once read, also the
  // tile's ds on its way to dbias); two statistics buffers: 50.7 KB at
  // dk <= 32, four blocks an SM
  return ((size_t)6 * k5::tile_elems<DKP>() + 2 * k5::bias_elems()) *
             sizeof(bf16) +
         2 * kStats * sizeof(float);
}

template <int DKP>
__global__ void __launch_bounds__(k5::kThreads, k5::bwd_min_blocks<DKP>())
    causal_attention_bwd_cols(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ bias,
    const bf16* __restrict__ dout, bf16* __restrict__ dk_out,
    bf16* __restrict__ dv, bf16* __restrict__ dbias,
    const float* __restrict__ stats, int N, int S, int dk, float inv_sqrt,
    uint32_t w1_base, cpc::Dropout drop) {
  constexpr int TE = k5::tile_elems<DKP>();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + TE;
  bf16* Qs = Vs + TE;              // 2 buffers
  bf16* Ds = Qs + 2 * TE;          // 2 buffers of do
  bf16* Bs = Ds + 2 * TE;          // 2 buffers of (64, kLdb)
  float* St = reinterpret_cast<float*>(Bs + 2 * k5::bias_elems());  // 2 x kStats

  const int n = blockIdx.y;
  const int kt = blockIdx.x;       // most query tiles first
  const int k0 = kt * k5::kTile;
  const int n_qt = gridDim.x;
  const size_t base = (size_t)n * S * dk;
  const bf16* bias_n = bias + (size_t)n * S * S;
  bf16* dbias_n = dbias + (size_t)n * S * S;
  const int warp = threadIdx.x >> 5;
  const bool rows16 = (S & 7) == 0;   // dbias rows 16-byte aligned
  const uint32_t row_key =
      drop.active() ? cpc::dropout_row_key(drop.seed_word(),
                                           cpc::kSiteARAttention,
                                           w1_base + (uint32_t)n)
                    : 0u;
  auto stage_tile = [&](int qt) {   // query tile qt into buffer (qt-kt) & 1
    const int b = (qt - kt) & 1, q0 = qt * k5::kTile;
    k5::stage_rows<DKP>(Qs + b * TE, q + base, q0, S, dk);
    k5::stage_rows<DKP>(Ds + b * TE, dout + base, q0, S, dk);
    k5::stage_bias(Bs + b * k5::bias_elems(), bias_n, q0, k0, S);
    float* st = St + b * kStats;
    for (int idx = threadIdx.x; idx < kStats; idx += k5::kThreads) {
      const int a = idx / k5::kTile, i = q0 + idx % k5::kTile;
      if (i < S)
        cpc::mma::cp_async4(st + idx, stats + (a * (size_t)N + n) * S + i);
    }
    cpc::mma::cp_async_commit();
  };

  k5::stage_rows<DKP>(Ks, k + base, k0, S, dk);
  k5::stage_rows<DKP>(Vs, v + base, k0, S, dk);
  stage_tile(kt);

  // dbias above this block's diagonal: rows [0, k0), columns [k0, k0 + 64)
  const int n_cols = min(k5::kTile, S - k0);
  if (rows16) {
    for (int idx = threadIdx.x; idx < k0 * 8; idx += k5::kThreads) {
      const int r = idx >> 3, c = (idx & 7) * 8;
      if (c < n_cols)
        *reinterpret_cast<uint4*>(dbias_n + (size_t)r * S + k0 + c) =
            make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int idx = threadIdx.x; idx < k0 * k5::kTile; idx += k5::kThreads) {
      const int r = idx >> 6, c = idx & 63;
      if (c < n_cols)
        dbias_n[(size_t)r * S + k0 + c] = __float2bfloat16(0.0f);
    }
  }

  float dka[DKP / 8][4], dva[DKP / 8][4];
#pragma unroll
  for (int nt = 0; nt < DKP / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[nt][e] = dva[nt][e] = 0.0f;

  for (int qt = kt; qt < n_qt; ++qt) {
    const int buf = (qt - kt) & 1;
    const int q0 = qt * k5::kTile;
    // on the diagonal tile, query n8 tiles before the warp's keys are
    // all masked; the dropout bits need no data: drawn while the tile is
    // in flight
    const int n_lo = qt == kt ? 2 * warp : 0;
    const uint32_t keep = k5::keep_bits<true>(drop, row_key, k0 + warp * 16,
                                              q0, n_lo, 8, S);
    if (qt + 1 < n_qt) {
      stage_tile(qt + 1);
      cpc::mma::cp_async_wait<1>();
    } else {
      cpc::mma::cp_async_wait<0>();
    }
    __syncthreads();
    float st[8][4], dpt[8][4];   // (16 keys, 64 queries)
    k5::rows_dot_rows<DKP>(st, Ks, warp * 16, Qs + buf * TE, n_lo, 8);
    k5::rows_dot_rows<DKP>(dpt, Vs, warp * 16, Ds + buf * TE, n_lo, 8);
    // the bias chunk; each element, once read, is overwritten with its ds
    // by the same thread: the (64 queries, kLdb) dbias tile
    bf16* DB = Bs + buf * k5::bias_elems();
    const float* sm = St + buf * kStats;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jl = warp * 16 + k5::row_of(e), il = k5::col_of(nt, e);
        const int j = k0 + jl, i = q0 + il;
        float pd = 0.0f, ds = 0.0f;
        if (j <= i && i < S) {
          const float x =
              (st[nt][e] + __bfloat162float(DB[il * k5::kLdb + jl])) *
              inv_sqrt;
          const float p = expf(x - sm[il]) * sm[k5::kTile + il];
          const float r = k5::kept_factor(drop, keep, nt, e);
          pd = p * r;
          ds = p * (dpt[nt][e] * r - sm[2 * k5::kTile + il]) * inv_sqrt;
        }
        st[nt][e] = pd;
        dpt[nt][e] = ds;
        DB[il * k5::kLdb + jl] = __float2bfloat16(ds);
      }
    k5::acc_times_rows<DKP, true>(dva, st, Ds + buf * TE, n_lo / 2, 4);
    k5::acc_times_rows<DKP, true>(dka, dpt, Qs + buf * TE, n_lo / 2, 4);
    __syncthreads();   // DB is whole; buffer `buf` is free
    const int n_rows = min(k5::kTile, S - q0);
    if (rows16) {
      for (int idx = threadIdx.x; idx < k5::kTile * 8; idx += k5::kThreads) {
        const int r = idx >> 3, c = (idx & 7) * 8;
        if (r < n_rows && c < n_cols)
          *reinterpret_cast<uint4*>(dbias_n + (size_t)(q0 + r) * S + k0 + c) =
              *reinterpret_cast<const uint4*>(DB + r * k5::kLdb + c);
      }
    } else {
      for (int idx = threadIdx.x; idx < k5::kTile * k5::kTile;
           idx += k5::kThreads) {
        const int r = idx >> 6, c = idx & 63;
        if (r < n_rows && c < n_cols)
          dbias_n[(size_t)(q0 + r) * S + k0 + c] = DB[r * k5::kLdb + c];
      }
    }
    __syncthreads();   // the next iteration restages this buffer
  }
  const float one[2] = {1.0f, 1.0f};
  k5::store_rows<DKP>(dk_out + base, dka, k0 + warp * 16, S, dk, one);
  k5::store_rows<DKP>(dv + base, dva, k0 + warp * 16, S, dk, one);
}

template <int DKP>
int launch_mma(const void* q, const void* k, const void* v, const void* bias,
               const void* dout, void* dq, void* dk_out, void* dv,
               void* dbias, float* stats, int N, int S, int dk, int layer,
               cpc::Dropout drop, cudaStream_t stream) {
  auto rows = causal_attention_bwd_rows<DKP>;
  auto cols = causal_attention_bwd_cols<DKP>;
  const size_t s1 = rows_smem_bytes<DKP>(), s2 = cols_smem_bytes<DKP>();
  cudaError_t err = cpc::allow_smem(rows, s1);
  if (err != cudaSuccess) return (int)err;
  err = cpc::allow_smem(cols, s2);
  if (err != cudaSuccess) return (int)err;
  const float inv_sqrt = 1.0f / sqrtf(static_cast<float>(dk));
  const uint32_t w1_base = (uint32_t)layer * (uint32_t)N;
  const dim3 grid((S + k5::kTile - 1) / k5::kTile, N);
  const bf16 *bq = static_cast<const bf16*>(q),
             *bk = static_cast<const bf16*>(k),
             *bv = static_cast<const bf16*>(v),
             *bb = static_cast<const bf16*>(bias),
             *bo = static_cast<const bf16*>(dout);
  rows<<<grid, k5::kThreads, s1, stream>>>(bq, bk, bv, bb, bo,
                                           static_cast<bf16*>(dq), stats, N,
                                           S, dk, inv_sqrt, w1_base, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cols<<<grid, k5::kThreads, s2, stream>>>(
      bq, bk, bv, bb, bo, static_cast<bf16*>(dk_out), static_cast<bf16*>(dv),
      static_cast<bf16*>(dbias), stats, N, S, dk, inv_sqrt, w1_base, drop);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32 body: exact FMA loops
// ---------------------------------------------------------------------------

constexpr int kFmaThreads = 256;

size_t fma_input_bytes(int S, int dk) {
  return ((size_t)S * dk * 2 + (size_t)S * (dk + 1) * 2) * sizeof(float);
}

size_t fma_tile_bytes(int S) { return (size_t)S * S * 2 * sizeof(float); }

// 0: inputs and tiles in shared memory; 1: inputs only (ds in dbias, p r
// in the scratch); 2: nothing staged.
int fma_mode(int S, int dk) {
  if (fma_input_bytes(S, dk) + fma_tile_bytes(S) <= cpc::kSmemLimit) return 0;
  return fma_input_bytes(S, dk) <= cpc::kSmemLimit ? 1 : 2;
}

__global__ void __launch_bounds__(kFmaThreads) causal_attention_bwd_fma(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ bias,
    const float* __restrict__ dout, float* __restrict__ dq,
    float* __restrict__ dk_out, float* __restrict__ dv, float* dbias,
    float* pd_scratch, int S, int dk, float inv_sqrt, uint32_t w1_base,
    cpc::Dropout drop, int mode) {
  extern __shared__ float smem[];
  const int n = blockIdx.x;
  const size_t base = (size_t)n * S * dk;
  const float* qs = q + base;        // (S, dk)
  const float* dos = dout + base;    // (S, dk)
  const float* ks = k + base;        // (S, ldk)
  const float* vs = v + base;        // (S, ldk)
  int ldk = dk;
  float* DS = dbias + (size_t)n * S * S;        // (S, S) ds
  float* PD = pd_scratch + (size_t)n * S * S;   // (S, S) p * r
  if (mode < 2) {
    ldk = dk + 1;                    // lanes reading different keys: banks
    float* sq = smem;
    float* sdo = sq + S * dk;
    float* sk = sdo + S * dk;
    float* sv = sk + S * ldk;
    for (int idx = threadIdx.x; idx < S * dk; idx += blockDim.x) {
      const int i = idx / dk;
      const int d = idx - i * dk;
      sq[idx] = q[base + idx];
      sdo[idx] = dout[base + idx];
      sk[i * ldk + d] = k[base + idx];
      sv[i * ldk + d] = v[base + idx];
    }
    qs = sq;
    dos = sdo;
    ks = sk;
    vs = sv;
    if (mode == 0) {
      DS = sv + S * ldk;
      PD = DS + S * S;
    }
  }
  const uint32_t row_key =
      drop.active() ? cpc::dropout_row_key(drop.seed_word(),
                                           cpc::kSiteARAttention,
                                           w1_base + (uint32_t)n)
                    : 0u;
  __syncthreads();

  const float* bias_n = bias + (size_t)n * S * S;
  float* dbias_n = dbias + (size_t)n * S * S;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;

  // ---- by query row: p, dp, ds, p * r; the dbias row and dq_i ----
  for (int i = warp; i < S; i += n_warps) {
    const float* qi = qs + i * dk;
    const float* doi = dos + i * dk;
    const float* bias_i = bias_n + (size_t)i * S;
    float* dsr = DS + i * S;
    float* pdr = PD + i * S;
    float mx = -INFINITY;
    for (int j = lane; j <= i; j += 32) {
      const float* kj = ks + j * ldk;
      float s = 0.0f;
      for (int d = 0; d < dk; ++d) s += qi[d] * kj[d];
      s = (s + bias_i[j]) * inv_sqrt;
      dsr[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = cpc::warp_max(mx);
    float sum = 0.0f;
    for (int j = lane; j <= i; j += 32) {
      const float e = expf(dsr[j] - mx);
      dsr[j] = e;
      sum += e;
    }
    const float inv_sum = 1.0f / cpc::warp_sum(sum);
    float pdp = 0.0f;
    for (int j = lane; j <= i; j += 32) {
      const float p = dsr[j] * inv_sum;
      const float* vj = vs + j * ldk;
      float dpd = 0.0f;
      for (int d = 0; d < dk; ++d) dpd += doi[d] * vj[d];
      const float dp = dpd * k5::drop_factor(drop, row_key, i, j, S);
      pdp += p * dp;
      pdr[j] = p;
      dsr[j] = dp;
    }
    const float c = cpc::warp_sum(pdp);
    for (int j = lane; j <= i; j += 32) {
      const float p = pdr[j];
      const float ds = p * (dsr[j] - c) * inv_sqrt;
      dsr[j] = ds;
      pdr[j] = p * k5::drop_factor(drop, row_key, i, j, S);
      dbias_n[(size_t)i * S + j] = ds;
    }
    for (int j = i + 1 + lane; j < S; j += 32)
      dbias_n[(size_t)i * S + j] = 0.0f;
    __syncwarp();
    for (int d = lane; d < dk; d += 32) {
      float acc = 0.0f;
      for (int j = 0; j <= i; ++j) acc += dsr[j] * ks[j * ldk + d];
      dq[base + (size_t)i * dk + d] = acc;
    }
    __syncwarp();
  }
  __syncthreads();

  // ---- by key column: dk_j, dv_j ----
  for (int j = warp; j < S; j += n_warps) {
    for (int d = lane; d < dk; d += 32) {
      float a = 0.0f, bsum = 0.0f;
      for (int i = j; i < S; ++i) {
        a += DS[i * S + j] * qs[i * dk + d];
        bsum += PD[i * S + j] * dos[i * dk + d];
      }
      dk_out[base + (size_t)j * dk + d] = a;
      dv[base + (size_t)j * dk + d] = bsum;
    }
  }
}

int launch_fma(const void* q, const void* k, const void* v, const void* bias,
               const void* dout, void* dq, void* dk_out, void* dv,
               void* dbias, float* scratch, int N, int S, int dk, int layer,
               cpc::Dropout drop, cudaStream_t stream) {
  const int mode = fma_mode(S, dk);
  if (mode > 0 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = mode == 0   ? fma_input_bytes(S, dk) + fma_tile_bytes(S)
                      : mode == 1 ? fma_input_bytes(S, dk)
                                  : 0;
  cudaError_t err = cpc::allow_smem(causal_attention_bwd_fma, smem);
  if (err != cudaSuccess) return (int)err;
  causal_attention_bwd_fma<<<N, kFmaThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(bias),
      static_cast<const float*>(dout), static_cast<float*>(dq),
      static_cast<float*>(dk_out), static_cast<float*>(dv),
      static_cast<float*>(dbias), scratch, S, dk,
      1.0f / sqrtf(static_cast<float>(dk)), (uint32_t)layer * (uint32_t)N,
      drop, mode);
  return (int)cudaGetLastError();
}

}  // namespace

// float32 scratch elements the backward needs: the rows' statistics
// (3, N, S) for bf16; for float32 the (N, S, S) p * r tiles where they
// leave shared memory, else none.
extern "C" size_t cpc_causal_attention_bwd_scratch(int N, int S, int dk,
                                                   int dtype) {
  if (dtype == cpc::kBFloat16) return (size_t)3 * N * S;
  if (dtype == cpc::kFloat32 && fma_mode(S, dk) > 0)
    return (size_t)N * S * S;
  return 0;
}

// q, k, v, dout and dq, dk, dv (N, S, dk), bias and dbias (N, S, S), all
// in `dtype`; scratch float32 of cpc_causal_attention_bwd_scratch elements
// (null when that is 0).  dk <= 128, in bf16 a multiple of 8 with 16-byte
// aligned rows.
extern "C" int cpc_causal_attention_bwd(
    const void* q, const void* k, const void* v, const void* bias,
    const void* dout, void* dq, void* dk, void* dv, void* dbias,
    void* scratch, int N, int S, int dkh, int layer, const void* seed,
    unsigned int threshold, float keep_scale, int dtype, void* stream) {
  if (N <= 0 || S <= 0 || dkh <= 0 || cpc::k5::padded_dk(dkh) == 0 ||
      (dtype == cpc::kBFloat16 && dkh % 8 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cpc::Dropout drop{static_cast<const int64_t*>(seed), threshold,
                          keep_scale};
  float* sc = static_cast<float*>(scratch);
  if (dtype == cpc::kBFloat16) {
    if (sc == nullptr) return (int)cudaErrorInvalidValue;
    switch (cpc::k5::padded_dk(dkh)) {
      case 32:
        return launch_mma<32>(q, k, v, bias, dout, dq, dk, dv, dbias, sc, N,
                              S, dkh, layer, drop, s);
      case 64:
        return launch_mma<64>(q, k, v, bias, dout, dq, dk, dv, dbias, sc, N,
                              S, dkh, layer, drop, s);
      default:
        return launch_mma<128>(q, k, v, bias, dout, dq, dk, dv, dbias, sc, N,
                               S, dkh, layer, drop, s);
    }
  }
  if (dtype == cpc::kFloat32)
    return launch_fma(q, k, v, bias, dout, dq, dk, dv, dbias, sc, N, S, dkh,
                      layer, drop, s);
  return (int)cudaErrorInvalidValue;
}
