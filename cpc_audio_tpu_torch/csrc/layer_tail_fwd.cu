// K3: transformer-layer tail, forward: LN1 -> FFN -> residual -> LN2.
//
// Replaces cpc_audio_tpu/ops/pallas/ffn.py `_tail_fwd_kernel` (called
// through `fused_layer_tail`).  Per head k and row:
//   y   = LN1(x)                        (f32 statistics, ddof 0; rounded to T)
//   h   = relu(y . W1[k] + b1[k]) * r   (rounded to T; r: dropout factor)
//   out = LN2(y + h . W2[k] + b2[k])
// The (rows, F) hidden never reaches device memory: that is the point of
// the kernel.  In training r drops hidden units (dropout.cuh, keyed on
// (k, row, f)); at rate 0 it is 1.
//
// Design: one block per (tile of rows, head k).  The tile's y sits in
// shared memory; the hidden is produced in chunks of FC columns (an
// FC-wide tile for the block's rows, in shared memory) and immediately
// contracted with the matching FC rows of W2 into a float32 accumulator
// of the block's whole rows x D output tile.  A 128-row bf16 hidden of width F = 2048 would be 512 KB,
// more than an SM's 227 KB of shared memory, hence the F-chunking.  Two
// bodies share that structure, each with three width classes (D up to
// 256, 512 and 1024, a multiple of 32):
//   * bf16 (F % 64 == 0): both products on the tensor cores through
//     warp-level mma (nvcuda::wmma, 16x16x16 bf16 fragments, float32
//     accumulation), MT rows per block (64 up to D = 256, 32 up to 512,
//     16 up to 1024, so that the MT x D output tile is always at most
//     four accumulator fragments per warp over 16 warps) and a hidden
//     chunk of WFC = 64 columns (32 past D = 512, where two 64-wide W1
//     and W2 chunks alone would take 279 KB); each chunk's W1 and W2
//     tiles are staged once in shared memory (16-byte loads) and read from
//     there by every warp.  The float32 x / y2 tile is used only before
//     and after the chunk loop, so it shares its shared memory with the
//     W1 and W2 chunks: 131 KB at D = 256, 187 KB at D = 512, 185 KB at
//     D = 1024;
//   * float32: plain FMA loops (TF32 would change the numbers), 256
//     threads up to D = 256 and 512 past it, each owning one output
//     column (two past D = 512) for all the block's rows in registers:
//     32 rows a block, 16 past D = 512 (so that x and y fit); the hidden
//     chunk is FC = threads * 8 / rows columns (64, 128, 256), a thread
//     computing 8 rows of one of them, and the last chunk of F may be
//     narrower, so F need only be a multiple of 32.
//
// What bounds it on an H100: at the main path's shapes (K = 12, rows =
// 3712, D = 256, F = 2048) the tail is 93 GFLOP.  The bf16 body also
// streams all of W1[k] and W2[k] (2 MB) from L2 into every block: 1.4 GB
// in all with 64-row blocks (8 MB a 16-row block at D = 1024).  A first
// version that read the fragments
// from L2 per warp moved ~5.6 GB and ran at ~2.4 TB/s of it, so the weight
// stream bounds this body; overlapping the staging with the products
// (cp.async/TMA double buffering) and wgmma are the next steps.
// The float32 body runs on the FP32 pipes and is arithmetic-bound.
#include <mma.h>

#include "common.cuh"
#include "dropout.cuh"
#include "layer_tail.cuh"

namespace {

// Mean and reciprocal std of each of the ROWS rows of xs (row stride ld)
// -> stat[0..ROWS) and stat[ROWS..2*ROWS).
template <int ROWS>
__device__ void row_stats(const float* xs, int ld, float* stat, int D,
                          float eps) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int r = warp; r < ROWS; r += n_warps) {
    const float* xr = xs + r * ld;
    float s = 0.0f;
    for (int d = lane; d < D; d += 32) s += xr[d];
    const float mean = cpc::warp_sum(s) / D;
    float v = 0.0f;
    for (int d = lane; d < D; d += 32) {
      const float c = xr[d] - mean;
      v += c * c;
    }
    const float var = cpc::warp_sum(v) / D;
    if (lane == 0) {
      stat[r] = mean;
      stat[ROWS + r] = rsqrtf(var + eps);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 body: tensor cores (wmma)
// ---------------------------------------------------------------------------

namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr int kMmaWarps = 16;
constexpr int kMaxTiles = 4;   // output tiles per warp: (MT/16)(D/16) / 16

// MT rows per block, so that the MT x D output tile is at most kMaxTiles
// fragments per warp; WFC hidden columns a chunk, (MT/16) x (WFC/16)
// hidden tiles, one a warp.
template <int MT, int WFC>
struct MmaSmem {
  int ldy, ldh, lds, ldx;
  size_t bytes;
  // ys, hs, the W1 and W2 chunks (which the float32 xs tile overlays), sc,
  // stat: every region starts on a 32-byte boundary
  __host__ __device__ explicit MmaSmem(int D)
      : ldy(D + 8), ldh(WFC + 8), lds(WFC + 4), ldx(D + 4) {
    bytes = ((size_t)MT * ldy + (size_t)MT * ldh + (size_t)D * ldh +
             (size_t)WFC * ldy) * sizeof(bf16) +
            ((size_t)MT * lds + 2 * MT) * sizeof(float);
  }
};

template <int MT, int WFC>
__global__ void __launch_bounds__(kMmaWarps * 32) layer_tail_fwd_mma_kernel(
    const bf16* __restrict__ x, const float* __restrict__ ln1w,
    const float* __restrict__ ln1b, const bf16* __restrict__ w1,
    const float* __restrict__ b1, const bf16* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ ln2w,
    const float* __restrict__ ln2b, bf16* __restrict__ out, int M, int D,
    int F, float eps, cpc::Dropout drop) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const MmaSmem<MT, WFC> L(D);
  // Every region starts on a 32-byte boundary, and every fragment pointer
  // below is 32-byte aligned (row tiles of 16 rows, column tiles of 16).
  bf16* ys = reinterpret_cast<bf16*>(smem_raw);      // (MT, ldy) y
  bf16* hs = ys + MT * L.ldy;                        // (MT, ldh) hidden
  bf16* w1s = hs + MT * L.ldh;                       // (D, ldh) W1 chunk
  bf16* w2s = w1s + D * L.ldh;                       // (WFC, ldy) W2 chunk
  float* sc = reinterpret_cast<float*>(w2s + WFC * L.ldy);  // (MT, lds)
  float* stat = sc + MT * L.lds;                     // (2, MT)
  // (MT, ldx) x, later y2: only before and after the chunk loop, over the
  // W1 and W2 chunks' space (MT (D + 4) floats fit in D (WFC + 8) + WFC
  // (D + 8) bf16)
  float* xs = reinterpret_cast<float*>(w1s);

  const int kk = blockIdx.y;
  const int row0 = blockIdx.x * MT;
  const int rows = min(MT, M - row0);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const size_t xoff = ((size_t)kk * M + row0) * D;

  for (int idx = tid; idx < MT * D; idx += blockDim.x) {
    const int r = idx / D, d = idx - r * D;
    xs[r * L.ldx + d] =
        r < rows ? __bfloat162float(x[xoff + (size_t)r * D + d]) : 0.0f;
  }
  __syncthreads();
  row_stats<MT>(xs, L.ldx, stat, D, eps);
  __syncthreads();
  for (int idx = tid; idx < MT * D; idx += blockDim.x) {
    const int r = idx / D, d = idx - r * D;
    ys[r * L.ldy + d] = __float2bfloat16(
        (xs[r * L.ldx + d] - stat[r]) * stat[MT + r] * ln1w[kk * D + d] +
        ln1b[kk * D + d]);
  }
  __syncthreads();

  const bf16* W1 = w1 + (size_t)kk * D * F;
  const bf16* W2 = w2 + (size_t)kk * F * D;
  const float* B1 = b1 + (size_t)kk * F;
  const int n_ct = D / 16;
  const int n_tiles = (MT / 16) * n_ct;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kMaxTiles];
#pragma unroll
  for (int i = 0; i < kMaxTiles; ++i) wmma::fill_fragment(acc[i], 0.0f);

  constexpr int kHidCols = WFC / 16;            // hidden tiles a row tile
  static_assert((MT / 16) * kHidCols <= kMmaWarps, "one hidden tile a warp");
  const int hrt = warp / kHidCols, hct = warp % kHidCols;
  for (int f0 = 0; f0 < F; f0 += WFC) {
    __syncthreads();   // the previous chunk's readers of w1s/w2s are done
    for (int idx = tid; idx < D * (WFC / 8); idx += blockDim.x) {
      const int d = idx / (WFC / 8), c8 = (idx - d * (WFC / 8)) * 8;
      *reinterpret_cast<uint4*>(w1s + d * L.ldh + c8) =
          *reinterpret_cast<const uint4*>(W1 + (size_t)d * F + f0 + c8);
    }
    for (int idx = tid; idx < WFC * (D / 8); idx += blockDim.x) {
      const int f = idx / (D / 8), c8 = (idx - f * (D / 8)) * 8;
      *reinterpret_cast<uint4*>(w2s + f * L.ldy + c8) =
          *reinterpret_cast<const uint4*>(W2 + (size_t)(f0 + f) * D + c8);
    }
    __syncthreads();
    if (hrt < MT / 16) {  // hidden tile = y . W1[:, f0 + 16*hct ...]
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::fill_fragment(c, 0.0f);
      for (int k = 0; k < D; k += 16) {
        wmma::load_matrix_sync(a, ys + hrt * 16 * L.ldy + k, L.ldy);
        wmma::load_matrix_sync(b, w1s + k * L.ldh + hct * 16, L.ldh);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(sc + hrt * 16 * L.lds + hct * 16, c, L.lds,
                              wmma::mem_row_major);
    }
    __syncthreads();
    for (int idx = tid; idx < MT * WFC; idx += blockDim.x) {
      const int r = idx / WFC, f = idx - r * WFC;
      float hv = fmaxf(sc[r * L.lds + f] + B1[f0 + f], 0.0f);
      if (drop.active())
        hv *= cpc::dropout_factor(
            cpc::dropout_row_key(drop.seed_word(), cpc::kSiteFFN,
                                 (uint32_t)(kk * M + row0 + r)),
            (uint32_t)(f0 + f), drop.threshold, drop.keep_scale);
      hs[r * L.ldh + f] = __float2bfloat16(hv);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kMaxTiles; ++i) {  // out tiles += hidden . W2[f0..]
      const int tile = warp + kMmaWarps * i;
      if (tile < n_tiles) {
        const int rt = tile / n_ct, ct = tile - rt * n_ct;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
#pragma unroll
        for (int kf = 0; kf < WFC; kf += 16) {
          wmma::load_matrix_sync(a, hs + rt * 16 * L.ldh + kf, L.ldh);
          wmma::load_matrix_sync(b, w2s + kf * L.ldy + ct * 16, L.ldy);
          wmma::mma_sync(acc[i], a, b, acc[i]);
        }
      }
    }
  }
  __syncthreads();   // xs overlays the chunks the last products read
#pragma unroll
  for (int i = 0; i < kMaxTiles; ++i) {
    const int tile = warp + kMmaWarps * i;
    if (tile < n_tiles) {
      const int rt = tile / n_ct, ct = tile - rt * n_ct;
      wmma::store_matrix_sync(xs + rt * 16 * L.ldx + ct * 16, acc[i], L.ldx,
                              wmma::mem_row_major);
    }
  }
  __syncthreads();
  for (int idx = tid; idx < MT * D; idx += blockDim.x) {
    const int r = idx / D, d = idx - r * D;
    xs[r * L.ldx + d] +=
        __bfloat162float(ys[r * L.ldy + d]) + b2[kk * D + d];
  }
  __syncthreads();
  row_stats<MT>(xs, L.ldx, stat, D, eps);
  __syncthreads();
  for (int idx = tid; idx < rows * D; idx += blockDim.x) {
    const int r = idx / D, d = idx - r * D;
    out[xoff + (size_t)r * D + d] = __float2bfloat16(
        (xs[r * L.ldx + d] - stat[r]) * stat[MT + r] * ln2w[kk * D + d] +
        ln2b[kk * D + d]);
  }
}

// ---------------------------------------------------------------------------
// FMA body (float32)
// ---------------------------------------------------------------------------

// kThreads threads, TM rows a block; thread t owns output columns t,
// t + kThreads, ... (CPT of them, those below D) for all TM rows, and, in
// each chunk of FC hidden columns, 8 rows of column t % FC.
template <typename T, int kThreads, int TM, int CPT>
__global__ void __launch_bounds__(kThreads) layer_tail_fwd_kernel(
    const T* __restrict__ x, const float* __restrict__ ln1w,
    const float* __restrict__ ln1b, const T* __restrict__ w1,
    const float* __restrict__ b1, const T* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ ln2w,
    const float* __restrict__ ln2b, T* __restrict__ out, int M, int D, int F,
    float eps, cpc::Dropout drop) {
  constexpr int FC = kThreads * 8 / TM;   // hidden columns a chunk
  constexpr int HS = TM + 4;   // row stride of the hidden chunk (16B aligned)
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                // (TM, D): x, later y + ffn
  float* yT = xs + TM * D;         // (D, TM): y = LN1(x), rounded to T
  float* hT = yT + D * TM;         // (FC, HS): hidden chunk, rounded to T
  float* stat = hT + FC * HS;      // (2, TM): mean, rstd

  const int kk = blockIdx.y;
  const int row0 = blockIdx.x * TM;
  const int rows = min(TM, M - row0);
  const int t = threadIdx.x;
  const size_t xoff = ((size_t)kk * M + row0) * D;

#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int d = t + c * kThreads;
    if (d < D) {
#pragma unroll 4
      for (int r = 0; r < TM; ++r)
        xs[r * D + d] =
            r < rows ? cpc::to_f32(x[xoff + (size_t)r * D + d]) : 0.0f;
    }
  }
  __syncthreads();
  row_stats<TM>(xs, D, stat, D, eps);
  __syncthreads();
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int d = t + c * kThreads;
    if (d < D) {
      const float w = ln1w[kk * D + d];
      const float bb = ln1b[kk * D + d];
#pragma unroll 4
      for (int r = 0; r < TM; ++r)
        yT[d * TM + r] = cpc::round_to<T>(
            (xs[r * D + d] - stat[r]) * stat[TM + r] * w + bb);
    }
  }
  __syncthreads();

  float acc[CPT][TM];
#pragma unroll
  for (int c = 0; c < CPT; ++c)
#pragma unroll
    for (int r = 0; r < TM; ++r) acc[c][r] = 0.0f;

  const T* W1 = w1 + (size_t)kk * D * F;
  const T* W2 = w2 + (size_t)kk * F * D;
  const float* B1 = b1 + (size_t)kk * F;
  const int fcol = t % FC;         // hidden column of this thread in a chunk
  const int r8 = (t / FC) * 8;     // its 8 rows (TM / 8 groups)
  for (int f0 = 0; f0 < F; f0 += FC) {
    const int fc = min(FC, F - f0);   // the last chunk may be narrower
    if (fcol < fc) {
      // hidden chunk: h[r8 .. r8+7, f0 + fcol]
      float ha[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) ha[i] = 0.0f;
      const T* w1c = W1 + f0 + fcol;
      for (int d = 0; d < D; ++d) {
        const float w = cpc::to_f32(w1c[(size_t)d * F]);
        const float4* yv = reinterpret_cast<const float4*>(yT + d * TM + r8);
        const float4 a = yv[0];
        const float4 c = yv[1];
        ha[0] += a.x * w; ha[1] += a.y * w; ha[2] += a.z * w; ha[3] += a.w * w;
        ha[4] += c.x * w; ha[5] += c.y * w; ha[6] += c.z * w; ha[7] += c.w * w;
      }
      const float bias = B1[f0 + fcol];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float hv = fmaxf(ha[i] + bias, 0.0f);
        if (drop.active())
          hv *= cpc::dropout_factor(
              cpc::dropout_row_key(drop.seed_word(), cpc::kSiteFFN,
                                   (uint32_t)(kk * M + row0 + r8 + i)),
              (uint32_t)(f0 + fcol), drop.threshold, drop.keep_scale);
        hT[fcol * HS + r8 + i] = cpc::round_to<T>(hv);
      }
    }
    __syncthreads();
    // acc[c][r] += sum_f h[r, f] * W2[f0 + f, t + c kThreads]; a second
    // column past D multiplies by 0 and is never stored
    if (t < D) {
      const T* w2c = W2 + (size_t)f0 * D + t;
      // unrolled by 4, so that several W2 loads are in flight (left to the
      // compiler, with the chunk's width a runtime bound, the loop ran
      // about 2.5 times slower on an H100)
#pragma unroll 4
      for (int f = 0; f < fc; ++f) {
        float w[CPT];
#pragma unroll
        for (int c = 0; c < CPT; ++c)
          w[c] = c == 0 || t + c * kThreads < D
                     ? cpc::to_f32(w2c[(size_t)f * D + c * kThreads])
                     : 0.0f;
        const float4* hv = reinterpret_cast<const float4*>(hT + f * HS);
#pragma unroll
        for (int q = 0; q < TM / 4; ++q) {
          const float4 hh = hv[q];
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            acc[c][4 * q + 0] += hh.x * w[c];
            acc[c][4 * q + 1] += hh.y * w[c];
            acc[c][4 * q + 2] += hh.z * w[c];
            acc[c][4 * q + 3] += hh.w * w[c];
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int d = t + c * kThreads;
    if (d < D) {
      const float bb = b2[kk * D + d];
#pragma unroll
      for (int r = 0; r < TM; ++r)
        xs[r * D + d] = yT[d * TM + r] + acc[c][r] + bb;
    }
  }
  __syncthreads();
  row_stats<TM>(xs, D, stat, D, eps);
  __syncthreads();
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int d = t + c * kThreads;
    if (d < D) {
      const float w = ln2w[kk * D + d];
      const float bb = ln2b[kk * D + d];
      for (int r = 0; r < rows; ++r)
        out[xoff + (size_t)r * D + d] = cpc::from_f32<T>(
            (xs[r * D + d] - stat[r]) * stat[TM + r] * w + bb);
    }
  }
}

template <typename T, int kThreads, int TM, int CPT>
int launch_fma(const void* x, const void* ln1w, const void* ln1b,
               const void* w1, const void* b1, const void* w2, const void* b2,
               const void* ln2w, const void* ln2b, void* out, int K, int M,
               int D, int F, float eps, cpc::Dropout drop,
               cudaStream_t stream) {
  constexpr int FC = kThreads * 8 / TM;
  const size_t floats = 2 * (size_t)TM * D + (size_t)FC * (TM + 4) + 2 * TM;
  const size_t smem = floats * sizeof(float);
  auto kernel = layer_tail_fwd_kernel<T, kThreads, TM, CPT>;
  cudaError_t err = cpc::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + TM - 1) / TM, K);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(ln1w),
      static_cast<const float*>(ln1b), static_cast<const T*>(w1),
      static_cast<const float*>(b1), static_cast<const T*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(ln2w),
      static_cast<const float*>(ln2b), static_cast<T*>(out), M, D, F, eps,
      drop);
  return (int)cudaGetLastError();
}

template <int MT, int WFC>
int launch_mma(const void* x, const void* ln1w, const void* ln1b,
               const void* w1, const void* b1, const void* w2, const void* b2,
               const void* ln2w, const void* ln2b, void* out, int K, int M,
               int D, int F, float eps, cpc::Dropout drop,
               cudaStream_t stream) {
  const size_t smem = MmaSmem<MT, WFC>(D).bytes;
  auto kernel = layer_tail_fwd_mma_kernel<MT, WFC>;
  cudaError_t err = cpc::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + MT - 1) / MT, K);
  kernel<<<grid, kMmaWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln1w),
      static_cast<const float*>(ln1b), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(ln2w),
      static_cast<const float*>(ln2b), static_cast<bf16*>(out), M, D, F, eps,
      drop);
  return (int)cudaGetLastError();
}

}  // namespace

// x, w1, w2 and out in `dtype`; the LN parameters and biases in float32.
// w1 and w2 must be 16-byte aligned (the bf16 body stages them with
// 16-byte loads).  D a multiple of 32 in [32, 1024]; F a multiple of 64
// (bf16) or 32 (float32).
extern "C" int cpc_layer_tail_fwd(const void* x, const void* ln1w,
                                  const void* ln1b, const void* w1,
                                  const void* b1, const void* w2,
                                  const void* b2, const void* ln2w,
                                  const void* ln2b, void* out, int K, int M,
                                  int D, int F, float eps, const void* seed,
                                  unsigned int threshold, float keep_scale,
                                  int dtype, void* stream) {
  if (D < 32 || D % 32 != 0 || D > cpc::kTailMaxD || F <= 0 || F % 32 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cpc::Dropout drop{static_cast<const int64_t*>(seed), threshold,
                          keep_scale};
  // each body's blocks by D's width class (layer_tail.cuh)
  using Launch = decltype(&launch_mma<64, 64>);
  const Launch kMma[cpc::kTailClasses] = {
      launch_mma<64, 64>, launch_mma<32, 64>, launch_mma<16, 32>};
  const Launch kFma[cpc::kTailClasses] = {
      launch_fma<float, 256, 32, 1>, launch_fma<float, 512, 32, 1>,
      launch_fma<float, 512, 16, 2>};
  const Launch* body = dtype == cpc::kBFloat16 && F % 64 == 0 ? kMma
                       : dtype == cpc::kFloat32               ? kFma
                                                              : nullptr;
  if (body == nullptr) return (int)cudaErrorInvalidValue;
  return body[cpc::tail_width_class(D)](x, ln1w, ln1b, w1, b1, w2, b2, ln2w,
                                        ln2b, out, K, M, D, F, eps, drop, s);
}
