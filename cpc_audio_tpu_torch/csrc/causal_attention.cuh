// K5's tensor-core (bf16) bodies, shared by causal_attention_fwd.cu and
// causal_attention_bwd.cu: tile sizes, the staging of q/k/v/do rows and of
// the bias's causal chunks with cp.async, and the warp-level products on
// mma.sync (mma.cuh) with the (row, column) of every accumulator element
// known, so that the bias, the causal mask, the softmax statistics and the
// dropout factor are applied in registers.
//
// A block holds 4 warps; a warp owns 16 rows of a 64-row tile (query rows
// in the forward and the backward's row kernel, keys in its column
// kernel).  q, k, v and do are staged as (64, DKP + 8) bf16 tiles: DKP is
// dk rounded up to 32, 64 or 128 with zero columns (zeros add nothing to
// a product), and the 8-element pad puts the rows of an ldmatrix read on
// distinct banks.
#pragma once

#include "common.cuh"
#include "dropout.cuh"
#include "mma.cuh"

namespace cpc {
namespace k5 {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;             // rows and keys per tile
constexpr int kWarps = 4;             // 16 rows each
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;               // row padding, elements
constexpr int kLdb = kTile + kPad;    // row stride of a bias / dbias tile

template <int DKP>
__host__ __device__ constexpr int ld() { return DKP + kPad; }

template <int DKP>
__host__ __device__ constexpr int tile_elems() { return kTile * ld<DKP>(); }

__host__ __device__ constexpr int bias_elems() { return kTile * kLdb; }

// Rows [r0, r0 + 64) of one n's (S, dk) matrix `src` into a (64, ld)
// tile, 16 bytes a copy; rows past S and columns past dk are zero-filled.
template <int DKP>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, int r0,
                                           int S, int dk) {
  constexpr int C = DKP / 8;
  for (int idx = threadIdx.x; idx < kTile * C; idx += kThreads) {
    const int r = idx / C, c = (idx - r * C) * 8;
    const bool ok = r0 + r < S && c < dk;
    mma::cp_async16(dst + r * ld<DKP>() + c,
                    ok ? src + (size_t)(r0 + r) * dk + c : src, ok);
  }
}

// The bias chunk rows [q0, q0 + 64) x keys [k0, k0 + 64) of one n's
// (S, S) bias into a (64, kLdb) tile, reading only its causal part (j <= i
// < S, to the 16-byte copy holding the diagonal); the rest is left zero.
// 16-byte copies where the rows are 16-byte aligned (S % 8 == 0), else
// element loads.
__device__ __forceinline__ void stage_bias(bf16* dst, const bf16* bias_n,
                                           int q0, int k0, int S) {
  if ((S & 7) == 0) {
    for (int idx = threadIdx.x; idx < kTile * 8; idx += kThreads) {
      const int r = idx >> 3, c = (idx & 7) * 8;
      const int i = q0 + r, j = k0 + c;
      const bool ok = i < S && j <= i;
      mma::cp_async16(dst + r * kLdb + c,
                      ok ? bias_n + (size_t)i * S + j : bias_n, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < kTile * kTile; idx += kThreads) {
      const int r = idx >> 6, c = idx & 63;
      const int i = q0 + r, j = k0 + c;
      dst[r * kLdb + c] = (i < S && j <= i) ? bias_n[(size_t)i * S + j]
                                            : __float2bfloat16(0.0f);
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

// s (the warp's 16 rows a0.. of tile A  x  the 64 rows of tile Bn, as 8
// n8 tiles) = A . Bn^T over DKP columns; n8 tiles outside [n_lo, n_hi) are
// left 0 and cost nothing.
template <int DKP>
__device__ __forceinline__ void rows_dot_rows(float s[8][4], const bf16* A,
                                              int a0, const bf16* Bn,
                                              int n_lo, int n_hi) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < DKP / 16; ++ks) {
    uint32_t a[4];
    mma::load_a(a, A, ld<DKP>(), a0, ks * 16);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      if (2 * np + 1 < n_lo || 2 * np >= n_hi) continue;
      uint32_t b[4];
      mma::load_b_nmajor(b, Bn, ld<DKP>(), np * 16, ks * 16);
      mma::mma_bf16(s[2 * np], a, b[0], b[1]);
      mma::mma_bf16(s[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 rows x DKP, as DKP / 8 n8 tiles) += P . Bk, with P the 16 x 64
// accumulator tiles p (rounded to bf16, or with SPLIT as the two-term
// hi + lo split) and Bk a k-major (64, DKP) tile, over the 16-column
// steps kk in [kk_lo, kk_hi).
template <int DKP, bool SPLIT>
__device__ __forceinline__ void acc_times_rows(float acc[DKP / 8][4],
                                               float p[8][4],
                                               const bf16* Bk, int kk_lo,
                                               int kk_hi) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (kk < kk_lo || kk >= kk_hi) continue;
    uint32_t hi[4], lo[4];
    if (SPLIT)
      mma::split_from_c(hi, lo, p[2 * kk], p[2 * kk + 1]);
    else
      mma::a_from_c(hi, p[2 * kk], p[2 * kk + 1]);
#pragma unroll
    for (int dp = 0; dp < DKP / 16; ++dp) {
      uint32_t b[4];
      mma::load_b_kmajor(b, Bk, ld<DKP>(), kk * 16, dp * 16);
      mma::mma_bf16(acc[2 * dp], hi, b[0], b[1]);
      mma::mma_bf16(acc[2 * dp + 1], hi, b[2], b[3]);
      if (SPLIT) {
        mma::mma_bf16(acc[2 * dp], lo, b[0], b[1]);
        mma::mma_bf16(acc[2 * dp + 1], lo, b[2], b[3]);
      }
    }
  }
}

// Writes the warp's 16 rows r0.. of acc * scale[row half] as bf16 to one
// n's (S, dk) matrix dst (rows < S, columns < dk).
template <int DKP>
__device__ __forceinline__ void store_rows(bf16* dst, float acc[DKP / 8][4],
                                           int r0, int S, int dk,
                                           const float scale[2]) {
#pragma unroll
  for (int nt = 0; nt < DKP / 8; ++nt) {
    const int d = col_of(nt, 0);
    if (d >= dk) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = r0 + row_of(2 * h);
      if (i < S)
        *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)i * dk + d) =
            __floats2bfloat162_rn(acc[nt][2 * h] * scale[h],
                                  acc[nt][2 * h + 1] * scale[h]);
    }
  }
}

__device__ __forceinline__ float drop_factor(const Dropout& drop,
                                             uint32_t row_key, int i, int j,
                                             int S) {
  return drop.active() ? dropout_factor(row_key, (uint32_t)(i * S + j),
                                        drop.threshold, drop.keep_scale)
                       : 1.0f;
}

// The dropout keep bits of a warp's 32 accumulator elements (bit 4 nt + e)
// of a tile whose rows start at r0 and columns at c0: the hash of
// dropout.cuh for the pair (query i, key j), where the rows are queries
// and the columns keys, or with KEY_ROWS the other way round (the
// backward's column kernel).  Drawn straight-line for the n8 tiles in
// [n_lo, n_hi) only (the others hold no causal pair of the warp: their
// probabilities are 0); all ones without dropout.  One draw per element
// serves every pass that reuses the bits.
template <bool KEY_ROWS = false>
__device__ __forceinline__ uint32_t keep_bits(const Dropout& drop,
                                              uint32_t row_key, int r0,
                                              int c0, int n_lo, int n_hi,
                                              int S) {
  if (!drop.active()) return 0xffffffffu;
  uint32_t bits = 0u;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
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

// Blocks an SM at the tile width DKP: the register budget of the
// backward's two kernels (65536 / (128 threads x blocks)), so that the
// 512 blocks of N = 256, S = 128 run in one wave at dk <= 32.
template <int DKP>
__host__ __device__ constexpr int bwd_min_blocks() {
  return DKP <= 32 ? 4 : DKP <= 64 ? 3 : 2;
}

// The dropout factor of element (nt, e) from its keep bit.
__device__ __forceinline__ float kept_factor(const Dropout& drop,
                                             uint32_t bits, int nt, int e) {
  return (bits >> (nt * 4 + e)) & 1u ? (drop.active() ? drop.keep_scale : 1.0f)
                                     : 0.0f;
}

// dk rounded up to the staged width: 32, 64 or 128 (0 above 128).
inline int padded_dk(int dk) {
  return dk <= 32 ? 32 : dk <= 64 ? 64 : dk <= 128 ? 128 : 0;
}

}  // namespace k5
}  // namespace cpc
