// K5's tensor-core body, one for both dtypes, shared by
// causal_attention_fwd.cu and causal_attention_bwd.cu, and the parts that
// K2's tensor-core body builds on (relpos_attention_tc.cuh): the tile geometry
// by dtype and padded head width, the staging of q/k/v/do rows and of the
// bias's causal chunks with cp.async, and the warp-level products on
// mma.sync (mma.cuh) with the (row, column) of every accumulator element
// known, so that the bias, the causal mask, the softmax statistics and the
// dropout factor are applied in registers.
//
// Operands.  In bf16, q, k, v and do are staged as they are.  In float32
// each is split once a call into P bf16 planes, each the bf16 rounding of
// what the planes before it left (`split_operands`, written (N, S, DKP)
// with zero columns past dk), and every product of two such operands is
// the sum of the split products plane i . plane j with i + j < P, exact
// term by term and summed in float32: P = 2 in the backward (hi.hi +
// hi.lo + lo.hi, about 2^-16 of each term left out), P = 3 in the forward
// (six products, about 2^-24: three planes hold a float32 exactly; at two
// the forward's error reached 17 % of chip_smoke's float32 tolerance).
// ops/causal_attention.py `causal_attention_split` writes that
// arithmetic.  Probabilities and ds, float32 accumulators, enter their
// products split into as many planes (in bf16 as two, only where the
// Pallas kernel multiplies them unrounded).  The bias stays in the input
// dtype and is read as it is; softmax statistics are float32 in both
// dtypes.
//
// Geometry (`Geom<T, DKP, P>`).  A block holds 4 warps.  DKP is dk rounded up
// to 32, 64, 128, 256 or 512 with zero columns (zeros add nothing to a
// product).  A tile holds kTile rows of q/k/v/do (query rows in the
// forward and the backward's row kernel, keys in its column kernel), each
// plane (kTile, DKP + 8) bf16: the 8-element pad puts the rows of an
// ldmatrix read on distinct banks.  Where a row's planes hold at most 128
// bf16 (bf16 up to DKP 128, float32 up to 64, or 32 in the forward's three
// planes) a tile is 64 rows and each warp owns 16 of them; wider, a tile is 32 rows, so that the backward's
// six staged tiles fit 227 KB (float32 at DKP 256: 214 KB), and the warps
// pair up on 16 rows, each owning half of the output columns (it forms
// the whole score tile, as its partner does, and accumulates 64 or 128
// columns: at most 128 float32 accumulators a lane for each output).
// At DKP 512 (--hiddenEncoder 4096: 8 heads of 512) a tile is 16 rows
// and all four warps share them, each owning a quarter of the output
// columns, 128: the accumulators stay at 64 a lane for each output, as
// at DKP 256, and the backward's six staged tiles take 100 KB in bf16 and
// 198 KB as float32's two planes.  (Walking dk in 256-column halves would
// keep 32-row tiles but form every score tile twice, or hold two 256-wide
// halves of dk and dv, 256 accumulators a lane, in the column kernel.)
// There the warps also split the reduction (`kSplitK`): warp w forms the
// partial scores over dk columns [128 w, 128 w + 128), the columns whose
// output it owns (in float32 every split product of its planes), and the
// four partial 16 x 16 float32 tiles pass through shared memory
// (`store_partial`, `load_sum`), summed in the fixed order w 0 + 1 + 2 + 3,
// so that every warp holds the same bits for the row max, the exp and the
// dropout factor.  Each score tile is formed once, not four times, for one
// more __syncthreads and 4 KB a tile of scores.  What bounds the 16-row
// tile is its p . v and the staging: 16 query rows a block read a whole
// (16, 512) key and value tile each.
#pragma once

#include "common.cuh"
#include "dropout.cuh"
#include "mma.cuh"

namespace cpc {
namespace k5 {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;               // row padding, elements

template <typename T, int DKP, int P = sizeof(T) == sizeof(float) ? 2 : 1>
struct Geom {
  static constexpr bool kF32 = sizeof(T) == sizeof(float);
  static constexpr int kPlanes = P;                  // bf16 planes a value
  static constexpr int kTile =                        // rows, keys
      DKP > 256 ? 16 : kPlanes * DKP <= 128 ? 64 : 32;
  static constexpr int kNT = kTile / 8;               // n8 tiles of a tile
  static constexpr int kRowWarps = kTile / 16;        // warps along rows
  static constexpr int kColWarps = kWarps / kRowWarps;  // along columns
  static constexpr int kDV = DKP / kColWarps;         // a warp's columns
  // the warps split the scores' reduction too: each forms the partial
  // over its kDV columns of dk
  static constexpr bool kSplitK = kColWarps == kWarps;
  static constexpr int kLd = DKP + kPad;              // row stride, a plane
  static constexpr int kPlaneElems = kTile * kLd;
  static constexpr int kTileElems = kPlanes * kPlaneElems;  // bf16, a tile
  static constexpr int kLdb = kTile + kPad;  // row stride of a bias tile
  static constexpr int kBiasElems = kTile * kLdb;            // of T
  // blocks an SM for the backward's register budget: at the bf16 widths
  // of 64-row tiles, 65536 / (128 threads x blocks), so that the 512
  // blocks of N = 256, S = 128 run in one wave at dk <= 32; elsewhere
  // shared memory allows at most two
  static constexpr int kMinBlocks =
      kF32 || DKP > 128 ? 1 : DKP <= 32 ? 4 : DKP <= 64 ? 3 : 2;
};

// Rows [r0, r0 + kTile) of one n's operand into a staged tile: each of
// its planes (`plane` elements apart in `src`, rows `lds` elements apart)
// into a (kTile, kLd) plane, 16 bytes a copy; rows past S and columns
// past `cols` are zero-filled.
template <typename G, int DKP>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           size_t plane, int r0, int S,
                                           int lds, int cols) {
  constexpr int C = DKP / 8;
#pragma unroll
  for (int p = 0; p < G::kPlanes; ++p)
    for (int idx = threadIdx.x; idx < G::kTile * C; idx += kThreads) {
      const int r = idx / C, c = (idx - r * C) * 8;
      const bool ok = r0 + r < S && c < cols;
      mma::cp_async16(dst + p * G::kPlaneElems + r * G::kLd + c,
                      ok ? src + p * plane + (size_t)(r0 + r) * lds + c : src,
                      ok);
    }
}

// The bias chunk rows [q0, q0 + kTile) x keys [k0, k0 + kTile) of one n's
// (S, S) bias into a (kTile, kLdb) tile, reading only its causal part
// (j <= i < S, to the 16-byte copy holding the diagonal); the rest is left
// zero.  16-byte copies where the rows are 16-byte aligned, else element
// loads.
template <typename G, typename T>
__device__ __forceinline__ void stage_bias(T* dst, const T* bias_n, int q0,
                                           int k0, int S) {
  constexpr int E = 16 / sizeof(T);   // elements a copy
  constexpr int C = G::kTile / E;     // copies a row
  if (S % E == 0) {
    for (int idx = threadIdx.x; idx < G::kTile * C; idx += kThreads) {
      const int r = idx / C, c = (idx % C) * E;
      const int i = q0 + r, j = k0 + c;
      const bool ok = i < S && j <= i;
      mma::cp_async16(dst + r * G::kLdb + c,
                      ok ? bias_n + (size_t)i * S + j : bias_n, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < G::kTile * G::kTile; idx += kThreads) {
      const int r = idx / G::kTile, c = idx % G::kTile;
      const int i = q0 + r, j = k0 + c;
      dst[r * G::kLdb + c] =
          (i < S && j <= i) ? bias_n[(size_t)i * S + j] : from_f32<T>(0.0f);
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Accumulator element e of an n8 tile: row offset g + 8 (e >> 1) within
// the warp's 16 rows, column 2t + (e & 1) within the tile.
__device__ __forceinline__ int row_of(int e) {
  return ((threadIdx.x & 31) >> 2) + ((e >> 1) << 3);
}
__device__ __forceinline__ int col_of(int nt, int e) {
  return nt * 8 + ((threadIdx.x & 3) << 1) + (e & 1);
}

// s (the warp's 16 rows a0.. of staged tile A  x  the kTile rows of staged
// tile Bn, as kNT n8 tiles) = A . Bn^T over DKP columns, in float32 as the
// split products of the planes, plane i of A times plane j of Bn for
// i + j < kPlanes, by increasing i + j; n8 tiles outside [n_lo, n_hi) are
// left 0 and cost nothing.
template <typename G, int DKP>
__device__ __forceinline__ void rows_dot_rows(float s[G::kNT][4],
                                              const bf16* A, int a0,
                                              const bf16* Bn, int n_lo,
                                              int n_hi) {
  constexpr int P = G::kPlanes;
#pragma unroll
  for (int nt = 0; nt < G::kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < DKP / 16; ++ks) {
    uint32_t a[P][4];
#pragma unroll
    for (int i = 0; i < P; ++i)
      mma::load_a(a[i], A + i * G::kPlaneElems, G::kLd, a0, ks * 16);
#pragma unroll
    for (int np = 0; np < G::kNT / 2; ++np) {
      if (2 * np + 1 < n_lo || 2 * np >= n_hi) continue;
      uint32_t b[P][4];
#pragma unroll
      for (int j = 0; j < P; ++j)
        mma::load_b_nmajor(b[j], Bn + j * G::kPlaneElems, G::kLd, np * 16,
                           ks * 16);
#pragma unroll
      for (int d = 0; d < P; ++d)
#pragma unroll
        for (int i = 0; i <= d; ++i) {
          mma::mma_bf16(s[2 * np], a[i], b[d - i][0], b[d - i][1]);
          mma::mma_bf16(s[2 * np + 1], a[i], b[d - i][2], b[d - i][3]);
        }
    }
  }
}

// Floats of shared memory a kSplitK tile of NT n8 tiles takes in
// `store_partial`: each warp's 32 lanes x NT x 4 accumulators.
template <int NT>
constexpr int kPartialFloats = kWarps * NT * 4 * 32;

// The warp's partial tile s (NT n8 tiles) into its slot of red, by lane,
// so that the stores and `load_sum`'s loads hit 32 distinct banks.
template <int NT>
__device__ __forceinline__ void store_partial(float* red,
                                              const float s[NT][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      red[((warp * NT + nt) * 4 + e) * 32 + lane] = s[nt][e];
}

// s = the four warps' partials of `store_partial` summed w 0 + 1 + 2 + 3,
// the same bits in every warp.  Between the stores and these loads a
// __syncthreads; before red is stored again, another.
template <int NT>
__device__ __forceinline__ void load_sum(float s[NT][4], const float* red) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int at = (nt * 4 + e) * 32 + lane;
      float x = red[at];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) x += red[w * NT * 128 + at];
      s[nt][e] = x;
    }
}

// At kSplitK: s = As . Bs^T and dp = Ad . Bd^T of the four warps' 16
// rows (n8 tiles outside [n_lo, n_hi) left 0), each warp forming its
// quarter c0 of dk, the partials summed through red (a __syncthreads
// inside; the caller syncs before red is stored again).
template <typename G>
__device__ __forceinline__ void split_products(float s[G::kNT][4],
                                               float dp[G::kNT][4],
                                               const bf16* As, const bf16* Bs,
                                               const bf16* Ad, const bf16* Bd,
                                               int n_lo, int n_hi, int c0,
                                               float* red) {
  rows_dot_rows<G, G::kDV>(s, As + c0, 0, Bs + c0, n_lo, n_hi);
  rows_dot_rows<G, G::kDV>(dp, Ad + c0, 0, Bd + c0, n_lo, n_hi);
  store_partial<G::kNT>(red, s);
  store_partial<G::kNT>(red + kPartialFloats<G::kNT>, dp);
  __syncthreads();
  load_sum<G::kNT>(s, red);
  load_sum<G::kNT>(dp, red + kPartialFloats<G::kNT>);
}

// acc (16 rows x the warp's kDV columns, as kDV / 8 n8 tiles) += P . Bk,
// with P the 16 x kTile accumulator tiles p (rounded to bf16, or with
// SPLIT as the two-term hi + lo split) and Bk a k-major staged tile from
// its column c0 on, over the 16-column steps kk in [kk_lo, kk_hi).  In
// float32 p is split into as many planes as Bk (SPLIT is implied) and the
// split products are plane i of p times plane j of Bk for i + j < kPlanes,
// by increasing i + j (hi.hi + lo.hi + hi.lo at two planes).
template <typename G, bool SPLIT>
__device__ __forceinline__ void acc_times_rows(float acc[G::kDV / 8][4],
                                               float p[G::kNT][4],
                                               const bf16* Bk, int kk_lo,
                                               int kk_hi) {
  constexpr int PB = G::kPlanes;                     // planes of Bk
  constexpr int PA = G::kF32 ? PB : SPLIT ? 2 : 1;   // planes of p
  constexpr int NP = PA > PB ? PA : PB;
#pragma unroll
  for (int kk = 0; kk < G::kNT / 2; ++kk) {
    if (kk < kk_lo || kk >= kk_hi) continue;
    uint32_t a[PA][4];
    if constexpr (PA == 1)
      mma::a_from_c(a[0], p[2 * kk], p[2 * kk + 1]);
    else if constexpr (PA == 2)
      mma::split_from_c(a[0], a[1], p[2 * kk], p[2 * kk + 1]);
    else
      mma::split3_from_c(a, p[2 * kk], p[2 * kk + 1]);
#pragma unroll
    for (int dp = 0; dp < G::kDV / 16; ++dp) {
      uint32_t b[PB][4];
#pragma unroll
      for (int j = 0; j < PB; ++j)
        mma::load_b_kmajor(b[j], Bk + j * G::kPlaneElems, G::kLd, kk * 16,
                           dp * 16);
#pragma unroll
      for (int d = 0; d < NP; ++d)
#pragma unroll
        for (int i = d; i >= 0; --i) {
          if (i >= PA || d - i >= PB) continue;
          mma::mma_bf16(acc[2 * dp], a[i], b[d - i][0], b[d - i][1]);
          mma::mma_bf16(acc[2 * dp + 1], a[i], b[d - i][2], b[d - i][3]);
        }
    }
  }
}

// Writes the warp's 16 rows r0.. of acc * scale[row half] in T to one n's
// (S, dk) matrix dst with rows ld elements apart (dk where 0), acc's
// columns from c0 on (rows < S, columns < dk).  bf16 pairs where dk is
// even (K5's dk % 8 == 0; K2's heads of any even width), else elements.
template <typename G, typename T>
__device__ __forceinline__ void store_rows(T* dst, float acc[G::kDV / 8][4],
                                           int r0, int c0, int S, int dk,
                                           const float scale[2],
                                           int ld = 0) {
  const size_t rs = ld ? ld : dk;
#pragma unroll
  for (int nt = 0; nt < G::kDV / 8; ++nt) {
    const int d = c0 + col_of(nt, 0);
    if (d >= dk) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = r0 + row_of(2 * h);
      if (i >= S) continue;
      const float x0 = acc[nt][2 * h] * scale[h],
                  x1 = acc[nt][2 * h + 1] * scale[h];
      if (G::kF32 || (dk & 1)) {   // element stores
        dst[i * rs + d] = from_f32<T>(x0);
        if (d + 1 < dk) dst[i * rs + d + 1] = from_f32<T>(x1);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(dst + i * rs + d) =
            __floats2bfloat162_rn(x0, x1);
      }
    }
  }
}

// The dropout keep bits of a warp's accumulator elements (bit 4 nt + e)
// of a tile whose rows start at r0 and columns at c0: the hash of
// dropout.cuh for the pair (query i, key j), where the rows are queries
// and the columns keys, or with KEY_ROWS the other way round (the
// backward's column kernel).  Drawn straight-line for the n8 tiles in
// [n_lo, n_hi) only (the others hold no causal pair of the warp: their
// probabilities are 0); all ones without dropout.  One draw per element
// serves every pass that reuses the bits.
template <typename G, bool KEY_ROWS = false>
__device__ __forceinline__ uint32_t keep_bits(const Dropout& drop,
                                              uint32_t row_key, int r0,
                                              int c0, int n_lo, int n_hi,
                                              int S) {
  if (!drop.active()) return 0xffffffffu;
  uint32_t bits = 0u;
#pragma unroll
  for (int nt = 0; nt < G::kNT; ++nt) {
    if (nt < n_lo || nt >= n_hi) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + row_of(e), c = c0 + col_of(nt, e);
      const int i = KEY_ROWS ? c : r, j = KEY_ROWS ? r : c;
      const uint32_t keep =
          fmix32(mix32((uint32_t)(i * S + j), row_key)) >= drop.threshold;
      bits |= keep << (nt * 4 + e);
    }
  }
  return bits;
}

// The dropout factor of element (nt, e) from its keep bit.
__device__ __forceinline__ float kept_factor(const Dropout& drop,
                                             uint32_t bits, int nt, int e) {
  return (bits >> (nt * 4 + e)) & 1u ? (drop.active() ? drop.keep_scale : 1.0f)
                                     : 0.0f;
}

// dk rounded up to the staged width: 32, 64, 128, 256 or 512 (0 above
// 512), the widths K2's tensor-core body takes too (past 512 its cluster
// body pads by 512-column slabs, relpos_attention_tc.cuh `padded_width`).
inline int padded_dk(int dk) {
  return dk <= 32    ? 32
         : dk <= 64  ? 64
         : dk <= 128 ? 128
         : dk <= 256 ? 256
         : dk <= 512 ? 512
                     : 0;
}

// Up to four float32 operands of one call, (rows, dk) each.
struct Operands {
  const float* x[4];
};

// The float32 operands' `n_planes` bf16 planes (2 or 3): operand o
// (blockIdx.y) of `src` to planes + o * (n_planes, rows, dkp) bf16, each
// plane the bf16 rounding of what the planes before it left, zero past
// dk.  Static: each translation unit has its own copy.
static __global__ void split_operands(Operands src, bf16* __restrict__ planes,
                                      int rows, int dk, int dkp,
                                      int n_planes) {
  const size_t n = (size_t)rows * dkp;
  const float* x = src.x[blockIdx.y];
  bf16* hi = planes + n_planes * n * blockIdx.y;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    const size_t r = e / dkp;
    const int c = (int)(e - r * dkp);
    float v = c < dk ? x[r * dk + c] : 0.0f;
    for (int p = 0; p < n_planes; ++p) {
      const bf16 h = __float2bfloat16(v);
      hi[p * n + e] = h;
      v -= __bfloat162float(h);
    }
  }
}

// Splits `n_ops` float32 operands of (rows, dk) into `n_planes` planes
// each on `stream`.
inline cudaError_t split(Operands src, int n_ops, int n_planes, bf16* planes,
                         int rows, int dk, cudaStream_t stream) {
  const int dkp = padded_dk(dk);
  const size_t n = (size_t)rows * dkp;
  const int blocks = (int)((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024);
  split_operands<<<dim3(blocks, n_ops), 256, 0, stream>>>(src, planes, rows,
                                                          dk, dkp, n_planes);
  return cudaGetLastError();
}

// Bytes of the float32 operands' planes: `n_ops` operands of (N, S, DKP),
// `n_planes` bf16 planes each.
inline size_t planes_bytes(int n_ops, int n_planes, int N, int S, int dk) {
  return (size_t)n_ops * n_planes * N * S * padded_dk(dk) * sizeof(bf16);
}

}  // namespace k5
}  // namespace cpc
