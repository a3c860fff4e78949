// The strided conv tile and the ChannelNorm statistics shared by the K7
// forward (csrc/conv_ln_fwd.cu) and the backward's rows pass
// (csrc/conv_ln_bwd.cu).
//
// Layout: x (B, T, C) channels-last, the conv weight w (2 s C, C) tap-major
// (the JAX WIO kernel reshaped), kernel = 2 s.  With the zero padding
// applied by index, output frame t of batch row b reads the padded rows
// t s .. t s + 2 s - 1, so its window, flattened as (tap, channel), is
//   A[t][j] = x[b][t s + j / C - pad][j % C]   (0 outside [0, T))
// and h[t] = A[t] . w: one product whose left operand is x itself with a
// row stride of s C.  A 64-wide chunk of j lies inside one tap (C % 64 ==
// 0), so every staged row is one contiguous run of x.
#pragma once

#include "tile_mm.cuh"

namespace cpc {
namespace conv {

constexpr int kThreads = 512;
constexpr int TM = 64;        // frames (or block rows) a block
constexpr int KC = 64;        // contraction chunk
constexpr int kPad = 8;       // row padding of staged tiles (16 B in bf16)
constexpr int kMaxC = 256;    // the widest layer: (TM, C) is 64 16x16 tiles

inline __host__ __device__ int out_frames(int T, int stride, int pad) {
  return (T + 2 * pad - 2 * stride) / stride + 1;
}

// a (TM, KC) and b (KC or C rows, up to C + pad) staged tiles, cs (TM, C)
// float32, stat (4, TM).
template <typename T>
struct Smem {
  T *a, *b;
  float *cs, *stat;
  int lda, ldb, ldc;
  size_t bytes;
  __host__ __device__ Smem(void* base, int a_cols, int b_rows, int b_cols,
                           int C)
      : lda(a_cols + kPad), ldb(b_cols + kPad), ldc(C + 4) {
    Carve cv(base);
    a = cv.take<T>((size_t)TM * lda);
    b = cv.take<T>((size_t)b_rows * ldb);
    cs = cv.take<float>((size_t)TM * ldc);
    stat = cv.take<float>(4 * TM);
    bytes = cv.bytes();
  }
};

// The forward's tiles: A chunk (TM, KC), w chunk (KC, C).
template <typename T>
__host__ __device__ Smem<T> frame_smem(void* base, int C) {
  return Smem<T>(base, KC, KC, C, C);
}

// A block's (TM, C) float32 tile in registers: 4 tiles of 16 x 16 a warp.
template <typename T>
using TileAcc = BlockAcc<T, (TM / 16) * (kMaxC / 16) / (kThreads / 32)>;

// cs[r][n] = sum_j A[t0 + r][j] w[j][n] for the frames t0 .. t0 + TM - 1 of
// batch row b (xb = x + b T C, 16-byte aligned); rows past out_t are zeros.
template <typename T>
__device__ void conv_tile(const Smem<T>& L, const T* __restrict__ xb,
                          const T* __restrict__ w, int T_len, int C,
                          int stride, int pad, int out_t, int t0) {
  constexpr int V = 16 / sizeof(T);    // elements a 16-byte piece
  const int kC = 2 * stride * C;
  TileAcc<T> acc;
  acc.zero();
  for (int k0 = 0; k0 < kC; k0 += KC) {
    const int tap = k0 / C;
    const int ch0 = k0 - tap * C;
    __syncthreads();   // earlier readers of the staged tiles are done
    for (int idx = threadIdx.x; idx < TM * (KC / V); idx += blockDim.x) {
      const int r = idx / (KC / V);
      const int j = (idx - r * (KC / V)) * V;
      const int t = t0 + r;
      const int row = t * stride + tap - pad;
      if (t < out_t && row >= 0 && row < T_len)
        copy16(L.a + r * L.lda + j, xb + (size_t)row * C + ch0 + j);
      else
        zero16(L.a + r * L.lda + j);
    }
    stage(L.b, L.ldb, w + (size_t)k0 * C, C, KC, C, KC);
    __syncthreads();
    acc.mma(L.a, L.lda, L.b, L.ldb, TM, C, KC);
  }
  acc.store(L.cs, L.ldc, TM, C);
  __syncthreads();
}

// For each of the first `rows` rows: cs[r] += bias, then the ChannelNorm
// statistics of h = cs[r] over its C channels: stat[r] = mean and
// stat[TM + r] = 1 / sqrt(var + eps) with the unbiased (ddof = 1) variance
// (cpc_audio_tpu/ops/pallas/conv_ln.py `_ln_unbiased_fwd`).  One warp a row.
template <typename T>
__device__ void norm_stats(const Smem<T>& L, const float* __restrict__ bias,
                           int rows, int C, float eps) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int r = warp; r < rows; r += n_warps) {
    float* h = L.cs + r * L.ldc;
    float s = 0.0f;
    for (int n = lane; n < C; n += 32) {
      h[n] += bias[n];
      s += h[n];
    }
    const float mean = warp_sum(s) / C;
    float v = 0.0f;
    for (int n = lane; n < C; n += 32) {
      const float d = h[n] - mean;
      v += d * d;
    }
    const float var = warp_sum(v) / (C - 1);
    if (lane == 0) {
      L.stat[r] = mean;
      L.stat[TM + r] = rsqrtf(var + eps);
    }
  }
  __syncthreads();
}

}  // namespace conv
}  // namespace cpc
