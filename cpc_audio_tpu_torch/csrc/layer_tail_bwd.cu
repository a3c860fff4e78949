// K3 backward: transformer-layer tail LN1 -> FFN -> residual -> LN2.
//
// Replaces cpc_audio_tpu/ops/pallas/ffn.py `_tail_bwd_kernel` (called
// through `_tail_bwd`).  Recompute-style, from x alone: per head k and row
//   y = round(LN1(x)),  h = round(relu(y W1 + b1) r),  y2 = y + h W2 + b2
//   dy2 = LN2'(do),     df = round(dy2),  dh = df W2^T
//   dhp = round(live ? dh / (1 - rate) : 0)   (live: kept and positive)
//   dy  = dy2 + dhp W1^T,  dx = LN1'(dy)
// and the parameter gradients, float32 sums over all rows:
//   dW1 = y^T dhp, db1 = sum dhp, dW2 = h^T df, db2 = sum df,
//   dln2w = sum do yhat2, dln2b = sum do, dln1w = sum dy yhat1, dln1b = sum dy.
// round() is the rounding to the input dtype T that the Pallas kernel
// applies before each product; r is the forward's dropout factor,
// regenerated from dropout.cuh (keyed on (k, row, f)).
//
// Two bodies.  bf16 runs six tensor-core GEMMs with fused epilogues
// (csrc/layer_tail_bwd_tc.cu, which says why); the entry points below
// dispatch to it.  This file holds the float32 body, exact FMA loops:
// one head's dW1 and dW2 are 2 MB each in float32, about nine times an
// SM's 227 KB of shared memory, and df needs the whole F-wide hidden
// before any dh exists.  The TPU kept both dW blocks resident in VMEM
// along a sequential row grid; Hopper blocks run in parallel, so the work
// is cut into two passes that never write the (rows, F) hidden to device
// memory:
//   1. `tail_bwd_rows_kernel`, one block per (row tile, k): recompute the
//      forward chunk by chunk of F (remembering the live mask as bits),
//      form dy2 and df, then stream the chunks again for dh -> dhp ->
//      dy += dhp W1^T, and emit dx.  It also writes y and df (the
//      compute dtype, (K, M, D)) for pass 2 and per-tile partial sums of
//      the five (K, D) vector gradients;
//   2. `tail_bwd_weights_kernel`, one block per (F chunk, k): with its
//      chunk of W1 and W2 resident in shared memory, loop over all rows,
//      recompute hp and dh for the chunk only, and accumulate that
//      chunk's dW1, dW2 and db1 in shared memory;
// and a small kernel sums the vector partials over tiles in a fixed
// order.  Pass 1 restages W1 and W2 twice per row tile, pass 2 re-reads y
// and df once per F chunk; both are bound by these stagings and by the
// serial phases of a block, not by the FMA rate.  D goes up to 1024 (K2's
// limit, 8 heads of dk <= 128): past D = 256, and again past 512, both
// passes take narrower row tiles and F chunks (`Tiles`), so that their
// D-wide tiles stay within an H100 block's 227 KB.
#include "common.cuh"
#include "dropout.cuh"
#include "layer_tail.cuh"
#include "layer_tail_bwd_tc.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kVecs = 5;   // dln1w, dln1b, db2, dln2w, dln2b

// Rows per tile and F columns per chunk of each pass of the float32 body,
// per width class W (layer_tail.cuh: D up to 256 << W), each with fewer
// rows and columns, so that the D-wide tiles of both passes stay within
// 227 KB of shared memory.  A chunk of pass 1 is 32 columns (a warp's
// ballot is one word of a row's live mask) or 16 (half a word: two rows a
// warp).

template <typename T, int W> struct Tiles;
template <> struct Tiles<float, 0> {
  static constexpr int kRows1 = 16, kChunk1 = 32, kRows2 = 16, kChunk2 = 32;
};
template <> struct Tiles<float, 1> {
  static constexpr int kRows1 = 8, kChunk1 = 32, kRows2 = 8, kChunk2 = 16;
};
template <> struct Tiles<float, 2> {
  static constexpr int kRows1 = 4, kChunk1 = 16, kRows2 = 8, kChunk2 = 8;
};

// Row padding, in elements, that keeps every row 16-byte aligned.
template <typename T>
constexpr int kPad = 16 / (int)sizeof(T);

// ---------------------------------------------------------------------------
// C (float32, row-major, ldc) (+)= A (Mr x Kd) . B (Kd x N), all in shared
// memory, as exact FMA loops.  A_COL / B_COL: the operand is stored
// column-major (element (r, c) at p[c * ld + r]), i.e. it is the
// transpose of a row-major tile.
// ---------------------------------------------------------------------------

template <bool A_COL, bool B_COL>
__device__ void block_gemm(float* C, int ldc, const float* A, int lda,
                           const float* B, int ldb, int Mr, int N, int Kd,
                           bool accumulate) {
  const int tn = N / 4;
  for (int t = threadIdx.x; t < (Mr / 4) * tn; t += blockDim.x) {
    const int m0 = (t / tn) * 4, n0 = (t - (t / tn) * tn) * 4;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j] = accumulate ? C[(m0 + i) * ldc + n0 + j] : 0.0f;
    for (int k = 0; k < Kd; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = A_COL ? A[k * lda + m0 + i] : A[(m0 + i) * lda + k];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = B_COL ? B[(n0 + j) * ldb + k] : B[k * ldb + n0 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) C[(m0 + i) * ldc + n0 + j] = acc[i][j];
  }
}

// dst (n_rows x n_cols, row stride ldd) <- src rows (stride lds); rows at or
// past `valid` are zero.  n_cols, ldd, lds and both bases are multiples of
// 16 bytes' worth of T.
template <typename T>
__device__ void stage(T* dst, int ldd, const T* src, size_t lds, int n_rows,
                      int valid, int n_cols) {
  constexpr int V = 16 / (int)sizeof(T);
  const int per_row = n_cols / V;
  for (int idx = threadIdx.x; idx < n_rows * per_row; idx += blockDim.x) {
    const int r = idx / per_row, c = (idx - r * per_row) * V;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + r * lds + c);
    *reinterpret_cast<uint4*>(dst + r * ldd + c) = val;
  }
}

// Mean and reciprocal std of the first n rows of xs (stride ld) -> mean[],
// inv[].
__device__ void row_stats(const float* xs, int ld, float* mean, float* inv,
                          int n, int D, float eps) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < n; r += blockDim.x >> 5) {
    const float* xr = xs + r * ld;
    float s = 0.0f;
    for (int d = lane; d < D; d += 32) s += xr[d];
    const float m = cpc::warp_sum(s) / D;
    float v = 0.0f;
    for (int d = lane; d < D; d += 32) v += (xr[d] - m) * (xr[d] - m);
    v = cpc::warp_sum(v) / D;
    if (lane == 0) {
      mean[r] = m;
      inv[r] = rsqrtf(v + eps);
    }
  }
}

__device__ __forceinline__ float drop_factor(const cpc::Dropout& drop,
                                             int row, int f) {
  if (!drop.active()) return 1.0f;
  return cpc::dropout_factor(
      cpc::dropout_row_key(drop.seed_word(), cpc::kSiteFFN, (uint32_t)row),
      (uint32_t)f, drop.threshold, drop.keep_scale);
}

// Carves shared memory into 128-byte aligned regions.
struct Carver {
  unsigned char* base;
  size_t off = 0;
  template <typename U>
  __host__ __device__ U* take(size_t n) {
    U* p = reinterpret_cast<U*>(base + off);
    off += (n * sizeof(U) + 127) / 128 * 128;
    return p;
  }
};

template <typename T, int W>
struct RowsLayout {
  int ldD, ldF, ldh, lda;
  T *Y, *DF, *W1c, *W2c, *HT;
  float *HP, *DH, *A32, *B32, *stat;
  uint32_t* live;
  size_t bytes;
  __host__ __device__ RowsLayout(unsigned char* base, int D, int F) {
    constexpr int MT = Tiles<T, W>::kRows1, FC = Tiles<T, W>::kChunk1;
    ldD = D + kPad<T>;
    ldF = FC + kPad<T>;
    ldh = FC + 4;
    lda = D + 4;
    Carver c{base};
    Y = c.take<T>((size_t)MT * ldD);
    DF = c.take<T>((size_t)MT * ldD);
    W1c = c.take<T>((size_t)D * ldF);
    W2c = c.take<T>((size_t)FC * ldD);
    HT = c.take<T>((size_t)MT * ldF);
    HP = c.take<float>((size_t)MT * ldh);
    DH = c.take<float>((size_t)MT * ldh);
    A32 = c.take<float>((size_t)MT * lda);
    B32 = c.take<float>((size_t)MT * lda);
    stat = c.take<float>(4 * MT);
    live = c.take<uint32_t>((size_t)MT * (F / 32));
    bytes = c.off;
  }
};

template <typename T, int W>
struct WeightsLayout {
  int ldD, ldF, ldh, ldw1, ldw2;
  T *W1c, *W2c, *Y, *DF, *HT, *DHP;
  float *DW1, *DW2, *HP, *DH, *db1;
  size_t bytes;
  __host__ __device__ WeightsLayout(unsigned char* base, int D) {
    constexpr int MT = Tiles<T, W>::kRows2, FC = Tiles<T, W>::kChunk2;
    ldD = D + kPad<T>;
    ldF = FC + kPad<T>;
    ldh = FC + 4;
    ldw1 = FC + 4;
    ldw2 = D + 4;
    Carver c{base};
    W1c = c.take<T>((size_t)D * ldF);
    W2c = c.take<T>((size_t)FC * ldD);
    Y = c.take<T>((size_t)MT * ldD);
    DF = c.take<T>((size_t)MT * ldD);
    HT = c.take<T>((size_t)MT * ldF);
    DHP = c.take<T>((size_t)MT * ldF);
    DW1 = c.take<float>((size_t)D * ldw1);
    DW2 = c.take<float>((size_t)FC * ldw2);
    HP = c.take<float>((size_t)MT * ldh);
    DH = c.take<float>((size_t)MT * ldh);
    db1 = c.take<float>(FC);
    bytes = c.off;
  }
};

// ---------------------------------------------------------------------------
// Pass 1: per (row tile, k).
// ---------------------------------------------------------------------------

template <typename T, int W>
__global__ void __launch_bounds__(kThreads) tail_bwd_rows_kernel(
    const T* __restrict__ x, const float* __restrict__ ln1w,
    const float* __restrict__ ln1b, const T* __restrict__ w1,
    const float* __restrict__ b1, const T* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ ln2w,
    const float* __restrict__ ln2b, const T* __restrict__ dout,
    T* __restrict__ dx, T* __restrict__ y_buf, T* __restrict__ df_buf,
    float* __restrict__ vec_part, int M, int D, int F, float eps,
    cpc::Dropout drop) {
  constexpr int MT = Tiles<T, W>::kRows1, FC = Tiles<T, W>::kChunk1;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const RowsLayout<T, W> L(smem_raw, D, F);
  float* mean1 = L.stat;
  float* inv1 = L.stat + MT;
  float* mean2 = L.stat + 2 * MT;
  float* inv2 = L.stat + 3 * MT;
  const int words = F / 32;

  const int kk = blockIdx.y;
  const int tile = blockIdx.x;
  const int row0 = tile * MT;
  const int rows = min(MT, M - row0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const size_t xoff = ((size_t)kk * M + row0) * D;
  const float* W1n = ln1w + kk * D;
  const float* B1n = ln1b + kk * D;
  const float* W2n = ln2w + kk * D;
  const float* B1 = b1 + (size_t)kk * F;
  const T* W1 = w1 + (size_t)kk * D * F;
  const T* W2 = w2 + (size_t)kk * F * D;
  const float scale = drop.active() ? drop.keep_scale : 1.0f;

  // ---- y = round(LN1(x)) ----
  for (int idx = tid; idx < MT * D; idx += blockDim.x) {
    const int r = idx / D, d = idx - r * D;
    L.A32[r * L.lda + d] =
        r < rows ? cpc::to_f32(x[xoff + (size_t)r * D + d]) : 0.0f;
  }
  __syncthreads();
  row_stats(L.A32, L.lda, mean1, inv1, MT, D, eps);
  __syncthreads();
  for (int idx = tid; idx < MT * D; idx += blockDim.x) {
    const int r = idx / D, d = idx - r * D;
    const T yv = cpc::from_f32<T>((L.A32[r * L.lda + d] - mean1[r]) *
                                      inv1[r] * W1n[d] + B1n[d]);
    L.Y[r * L.ldD + d] = yv;
    if (r < rows) y_buf[xoff + (size_t)r * D + d] = yv;
  }
  __syncthreads();

  // ---- forward: f = round(relu(y W1 + b1) r) W2, live bits ----
  for (int f0 = 0; f0 < F; f0 += FC) {
    stage(L.W1c, L.ldF, W1 + f0, (size_t)F, D, D, FC);
    stage(L.W2c, L.ldD, W2 + (size_t)f0 * D, (size_t)D, FC, FC, D);
    __syncthreads();
    block_gemm<false, false>(L.HP, L.ldh, L.Y, L.ldD, L.W1c, L.ldF, MT, FC,
                             D, false);
    __syncthreads();
    for (int idx = tid; idx < MT * FC; idx += blockDim.x) {
      const int r = idx / FC, c = idx - r * FC;
      const float hv = fmaxf(L.HP[r * L.ldh + c] + B1[f0 + c], 0.0f) *
                       drop_factor(drop, kk * M + row0 + r, f0 + c);
      L.HT[r * L.ldF + c] = cpc::from_f32<T>(hv);
      const unsigned word = __ballot_sync(0xffffffffu, hv > 0.0f);
      if constexpr (FC % 32 == 0) {
        if (lane == 0) L.live[r * words + (f0 + c) / 32] = word;
      } else if (c == 0) {
        // lanes [lane, lane + FC) hold this row's bits: half a word, the
        // chunk at f0 % 32 == 0 starts it, the next one completes it
        const uint32_t bits = (word >> lane) & ((1u << FC) - 1u);
        uint32_t* w = L.live + r * words + f0 / 32;
        *w = (f0 % 32 == 0 ? 0u : *w) | (bits << (f0 % 32));
      }
    }
    __syncthreads();
    block_gemm<false, false>(L.B32, L.lda, L.HT, L.ldF, L.W2c, L.ldD, MT, D,
                             FC, f0 > 0);
    __syncthreads();
  }

  // ---- y2 = y + f + b2; dy2 = LN2'(do) -> A32, df = round(dy2) ----
  for (int idx = tid; idx < MT * D; idx += blockDim.x) {
    const int r = idx / D, d = idx - r * D;
    L.B32[r * L.lda + d] += cpc::to_f32(L.Y[r * L.ldD + d]) + b2[kk * D + d];
  }
  __syncthreads();
  row_stats(L.B32, L.lda, mean2, inv2, MT, D, eps);
  __syncthreads();
  for (int r = warp; r < MT; r += n_warps) {
    float s1 = 0.0f, s2 = 0.0f;
    for (int d = lane; d < D; d += 32) {
      const float yh = (L.B32[r * L.lda + d] - mean2[r]) * inv2[r];
      const float g = r < rows
          ? cpc::to_f32(dout[xoff + (size_t)r * D + d]) * W2n[d] : 0.0f;
      s1 += g;
      s2 += g * yh;
    }
    const float m1 = cpc::warp_sum(s1) / D;
    const float m2 = cpc::warp_sum(s2) / D;
    for (int d = lane; d < D; d += 32) {
      const float yh = (L.B32[r * L.lda + d] - mean2[r]) * inv2[r];
      const float g = r < rows
          ? cpc::to_f32(dout[xoff + (size_t)r * D + d]) * W2n[d] : 0.0f;
      const float dy2 = (g - m1 - yh * m2) * inv2[r];
      L.A32[r * L.lda + d] = dy2;
      const T dfv = cpc::from_f32<T>(dy2);
      L.DF[r * L.ldD + d] = dfv;
      if (r < rows) df_buf[xoff + (size_t)r * D + d] = dfv;
    }
  }
  __syncthreads();
  const int n_tiles = gridDim.x;
  float* part = vec_part + ((size_t)kk * n_tiles + tile) * kVecs * D;
  for (int d = tid; d < D; d += blockDim.x) {
    float s_db2 = 0.0f, s_w = 0.0f, s_b = 0.0f;
    for (int r = 0; r < rows; ++r) {
      const float g = cpc::to_f32(dout[xoff + (size_t)r * D + d]);
      s_w += g * (L.B32[r * L.lda + d] - mean2[r]) * inv2[r];
      s_b += g;
      s_db2 += cpc::to_f32(L.DF[r * L.ldD + d]);
    }
    part[2 * D + d] = s_db2;
    part[3 * D + d] = s_w;
    part[4 * D + d] = s_b;
  }
  __syncthreads();

  // ---- dh = df W2^T -> dhp -> dy += dhp W1^T (accumulated in B32) ----
  for (int f0 = 0; f0 < F; f0 += FC) {
    stage(L.W1c, L.ldF, W1 + f0, (size_t)F, D, D, FC);
    stage(L.W2c, L.ldD, W2 + (size_t)f0 * D, (size_t)D, FC, FC, D);
    __syncthreads();
    block_gemm<false, true>(L.DH, L.ldh, L.DF, L.ldD, L.W2c, L.ldD, MT, FC,
                            D, false);
    __syncthreads();
    for (int idx = tid; idx < MT * FC; idx += blockDim.x) {
      const int r = idx / FC, c = idx - r * FC;
      const bool live =
          (L.live[r * words + (f0 + c) / 32] >> ((f0 + c) & 31)) & 1u;
      L.HT[r * L.ldF + c] =
          cpc::from_f32<T>(live ? L.DH[r * L.ldh + c] * scale : 0.0f);
    }
    __syncthreads();
    block_gemm<false, true>(L.B32, L.lda, L.HT, L.ldF, L.W1c, L.ldF, MT, D,
                            FC, f0 > 0);
    __syncthreads();
  }

  // ---- dy = dy2 + dyf; dx = LN1'(dy); dln1 partials ----
  for (int r = warp; r < MT; r += n_warps) {
    float s1 = 0.0f, s2 = 0.0f;
    for (int d = lane; d < D; d += 32) {
      const float dy = L.A32[r * L.lda + d] + L.B32[r * L.lda + d];
      const float xv =
          r < rows ? cpc::to_f32(x[xoff + (size_t)r * D + d]) : 0.0f;
      const float yh = (xv - mean1[r]) * inv1[r];
      L.A32[r * L.lda + d] = dy;
      L.B32[r * L.lda + d] = yh;
      s1 += dy * W1n[d];
      s2 += dy * W1n[d] * yh;
    }
    const float m1 = cpc::warp_sum(s1) / D;
    const float m2 = cpc::warp_sum(s2) / D;
    if (r < rows) {
      for (int d = lane; d < D; d += 32) {
        const float yh = L.B32[r * L.lda + d];
        dx[xoff + (size_t)r * D + d] = cpc::from_f32<T>(
            (L.A32[r * L.lda + d] * W1n[d] - m1 - yh * m2) * inv1[r]);
      }
    }
  }
  __syncthreads();
  for (int d = tid; d < D; d += blockDim.x) {
    float s_w = 0.0f, s_b = 0.0f;
    for (int r = 0; r < rows; ++r) {
      s_w += L.A32[r * L.lda + d] * L.B32[r * L.lda + d];
      s_b += L.A32[r * L.lda + d];
    }
    part[d] = s_w;
    part[D + d] = s_b;
  }
}

// ---------------------------------------------------------------------------
// Pass 2: per (F chunk, k).
// ---------------------------------------------------------------------------

template <typename T, int W>
__global__ void __launch_bounds__(kThreads) tail_bwd_weights_kernel(
    const T* __restrict__ y_buf, const T* __restrict__ df_buf,
    const T* __restrict__ w1, const float* __restrict__ b1,
    const T* __restrict__ w2, float* __restrict__ dw1,
    float* __restrict__ db1, float* __restrict__ dw2, int M, int D, int F,
    cpc::Dropout drop) {
  constexpr int MT = Tiles<T, W>::kRows2, FC = Tiles<T, W>::kChunk2;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const WeightsLayout<T, W> L(smem_raw, D);
  const int kk = blockIdx.y;
  const int f0 = blockIdx.x * FC;
  const int tid = threadIdx.x;
  const float scale = drop.active() ? drop.keep_scale : 1.0f;
  const float* B1 = b1 + (size_t)kk * F;

  stage(L.W1c, L.ldF, w1 + (size_t)kk * D * F + f0, (size_t)F, D, D, FC);
  stage(L.W2c, L.ldD, w2 + ((size_t)kk * F + f0) * D, (size_t)D, FC, FC, D);
  for (int idx = tid; idx < D * L.ldw1; idx += blockDim.x) L.DW1[idx] = 0.0f;
  for (int idx = tid; idx < FC * L.ldw2; idx += blockDim.x) L.DW2[idx] = 0.0f;
  if (tid < FC) L.db1[tid] = 0.0f;

  for (int row0 = 0; row0 < M; row0 += MT) {
    const int rows = min(MT, M - row0);
    const size_t off = ((size_t)kk * M + row0) * D;
    stage(L.Y, L.ldD, y_buf + off, (size_t)D, MT, rows, D);
    stage(L.DF, L.ldD, df_buf + off, (size_t)D, MT, rows, D);
    __syncthreads();
    block_gemm<false, false>(L.HP, L.ldh, L.Y, L.ldD, L.W1c, L.ldF, MT, FC,
                             D, false);
    block_gemm<false, true>(L.DH, L.ldh, L.DF, L.ldD, L.W2c, L.ldD, MT, FC,
                            D, false);
    __syncthreads();
    for (int idx = tid; idx < MT * FC; idx += blockDim.x) {
      const int r = idx / FC, c = idx - r * FC;
      const float hv = r < rows
          ? fmaxf(L.HP[r * L.ldh + c] + B1[f0 + c], 0.0f) *
                drop_factor(drop, kk * M + row0 + r, f0 + c)
          : 0.0f;
      L.HT[r * L.ldF + c] = cpc::from_f32<T>(hv);
      L.DHP[r * L.ldF + c] =
          cpc::from_f32<T>(hv > 0.0f ? L.DH[r * L.ldh + c] * scale : 0.0f);
    }
    __syncthreads();
    if (tid < FC) {
      float s = 0.0f;
      for (int r = 0; r < rows; ++r) s += cpc::to_f32(L.DHP[r * L.ldF + tid]);
      L.db1[tid] += s;
    }
    // dW1 chunk += y^T dhp;  dW2 chunk += h^T df
    block_gemm<true, false>(L.DW1, L.ldw1, L.Y, L.ldD, L.DHP, L.ldF, D, FC,
                            MT, true);
    block_gemm<true, false>(L.DW2, L.ldw2, L.HT, L.ldF, L.DF, L.ldD, FC, D,
                            MT, true);
    __syncthreads();
  }
  for (int idx = tid; idx < D * FC; idx += blockDim.x) {
    const int d = idx / FC, c = idx - d * FC;
    dw1[((size_t)kk * D + d) * F + f0 + c] = L.DW1[d * L.ldw1 + c];
  }
  for (int idx = tid; idx < FC * D; idx += blockDim.x) {
    const int c = idx / D, d = idx - c * D;
    dw2[((size_t)kk * F + f0 + c) * D + d] = L.DW2[c * L.ldw2 + d];
  }
  if (tid < FC) db1[(size_t)kk * F + f0 + tid] = L.db1[tid];
}

// out[v][k][d] = sum over tiles of part[k][tile][v][d], in tile order.
__global__ void tail_vec_reduce_kernel(const float* __restrict__ part,
                                       float* __restrict__ out, int K,
                                       int n_tiles, int D) {
  const int kk = blockIdx.x;
  for (int e = threadIdx.x; e < kVecs * D; e += blockDim.x) {
    float s = 0.0f;
    for (int t = 0; t < n_tiles; ++t)
      s += part[((size_t)kk * n_tiles + t) * kVecs * D + e];
    const int v = e / D, d = e - v * D;
    out[((size_t)v * K + kk) * D + d] = s;
  }
}

template <typename T, int W>
size_t smem_rows(int D, int F) {
  return RowsLayout<T, W>(nullptr, D, F).bytes;
}
template <typename T, int W>
size_t smem_weights(int D) {
  return WeightsLayout<T, W>(nullptr, D).bytes;
}

template <typename T, int W>
size_t smem_both(int D, int F) {
  const size_t a = smem_rows<T, W>(D, F), b = smem_weights<T, W>(D);
  return a > b ? a : b;
}

template <typename T, int W>
int n_row_tiles(int M) {
  return (M + Tiles<T, W>::kRows1 - 1) / Tiles<T, W>::kRows1;
}

template <typename T, int W>
int launch(const void* x, const float* ln1w, const float* ln1b,
           const void* w1, const float* b1, const void* w2, const float* b2,
           const float* ln2w, const float* ln2b, const void* dout, void* dx,
           void* y_buf, void* df_buf, float* vec_part, float* vec_out,
           float* dw1, float* db1, float* dw2, int K, int M, int D, int F,
           float eps, cpc::Dropout drop, cudaStream_t stream) {
  const size_t s1 = smem_rows<T, W>(D, F);
  const size_t s2 = smem_weights<T, W>(D);
  auto k1 = tail_bwd_rows_kernel<T, W>;
  auto k2 = tail_bwd_weights_kernel<T, W>;
  cudaError_t err = cpc::allow_smem(k1, s1);
  if (err != cudaSuccess) return (int)err;
  err = cpc::allow_smem(k2, s2);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = n_row_tiles<T, W>(M);
  k1<<<dim3(n_tiles, K), kThreads, s1, stream>>>(
      static_cast<const T*>(x), ln1w, ln1b, static_cast<const T*>(w1), b1,
      static_cast<const T*>(w2), b2, ln2w, ln2b, static_cast<const T*>(dout),
      static_cast<T*>(dx), static_cast<T*>(y_buf), static_cast<T*>(df_buf),
      vec_part, M, D, F, eps, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k2<<<dim3(F / Tiles<T, W>::kChunk2, K), kThreads, s2, stream>>>(
      static_cast<const T*>(y_buf), static_cast<const T*>(df_buf),
      static_cast<const T*>(w1), b1, static_cast<const T*>(w2), dw1, db1,
      dw2, M, D, F, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tail_vec_reduce_kernel<<<K, 256, 0, stream>>>(vec_part, vec_out, K,
                                                n_tiles, D);
  return (int)cudaGetLastError();
}

template <typename T>
bool shapes_ok(int D, int F) {
  constexpr int c = Tiles<T, 0>::kChunk1 > Tiles<T, 0>::kChunk2
                        ? Tiles<T, 0>::kChunk1
                        : Tiles<T, 0>::kChunk2;
  return D >= 32 && D % 32 == 0 && D <= cpc::kTailMaxD && F % c == 0 && F > 0;
}

}  // namespace

// Row tiles of the body's vector partials (the wrapper sizes vec_part with
// it: pass 1's in float32, G2/G4's in bf16), the shared memory of its
// largest block, and the device-memory scratch it needs beside y_buf and
// df_buf (none in float32); 0 for a bad dtype.
extern "C" int cpc_layer_tail_bwd_tiles(int M, int D, int dtype) {
  if (dtype == cpc::kBFloat16) return cpc::tail_tc::row_tiles(M, D);
  int (*const kTiles[cpc::kTailClasses])(int) = {
      n_row_tiles<float, 0>, n_row_tiles<float, 1>, n_row_tiles<float, 2>};
  if (dtype == cpc::kFloat32) return kTiles[cpc::tail_width_class(D)](M);
  return 0;
}

extern "C" size_t cpc_layer_tail_bwd_smem(int D, int F, int dtype) {
  if (dtype == cpc::kBFloat16) return cpc::tail_tc::smem_bytes(D);
  size_t (*const kSmem[cpc::kTailClasses])(int, int) = {
      smem_both<float, 0>, smem_both<float, 1>, smem_both<float, 2>};
  if (dtype == cpc::kFloat32) return kSmem[cpc::tail_width_class(D)](D, F);
  return 0;
}

extern "C" size_t cpc_layer_tail_bwd_scratch(int K, int M, int D, int F,
                                             int dtype) {
  return dtype == cpc::kBFloat16 ? cpc::tail_tc::scratch_bytes(K, M, D, F)
                                 : 0;
}

// x, w1, w2, dout, dx and the scratch y_buf, df_buf ((K, M, D)) in `dtype`;
// the LN parameters and biases float32; outputs vec_out (5, K, D) =
// (dln1w, dln1b, db2, dln2w, dln2b), dw1 (K, D, F), db1 (K, F), dw2
// (K, F, D) float32; vec_part is float32 scratch of K * tiles * 5 * D
// elements, and `scratch` cpc_layer_tail_bwd_scratch bytes (unused in
// float32).
extern "C" int cpc_layer_tail_bwd(
    const void* x, const void* ln1w, const void* ln1b, const void* w1,
    const void* b1, const void* w2, const void* b2, const void* ln2w,
    const void* ln2b, const void* dout, void* dx, void* y_buf, void* df_buf,
    void* vec_part, void* vec_out, void* dw1, void* db1, void* dw2,
    void* scratch, int K, int M, int D, int F, float eps, const void* seed,
    unsigned int threshold, float keep_scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cpc::Dropout drop{static_cast<const int64_t*>(seed), threshold,
                          keep_scale};
  const float* f[6] = {
      static_cast<const float*>(ln1w), static_cast<const float*>(ln1b),
      static_cast<const float*>(b1),   static_cast<const float*>(b2),
      static_cast<const float*>(ln2w), static_cast<const float*>(ln2b)};
  float* vp = static_cast<float*>(vec_part);
  float* vo = static_cast<float*>(vec_out);
  float* o1 = static_cast<float*>(dw1);
  float* ob = static_cast<float*>(db1);
  float* o2 = static_cast<float*>(dw2);
  if (dtype == cpc::kBFloat16 && cpc::tail_tc::shapes_ok(D, F))
    return cpc::tail_tc::launch(x, f[0], f[1], w1, f[2], w2, f[3], f[4],
                                f[5], dout, dx, y_buf, df_buf, vp, vo, o1, ob,
                                o2, scratch, K, M, D, F, eps, drop, s);
  const decltype(&launch<float, 0>) kLaunch[cpc::kTailClasses] = {
      launch<float, 0>, launch<float, 1>, launch<float, 2>};
  if (dtype == cpc::kFloat32 && shapes_ok<float>(D, F))
    return kLaunch[cpc::tail_width_class(D)](
        x, f[0], f[1], w1, f[2], w2, f[3], f[4], f[5], dout, dx, y_buf,
        df_buf, vp, vo, o1, ob, o2, K, M, D, F, eps, drop, s);
  return (int)cudaErrorInvalidValue;
}
