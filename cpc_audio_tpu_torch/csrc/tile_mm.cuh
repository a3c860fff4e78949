// Block-level products on shared-memory tiles, and the staging around them,
// for K7's fused conv layer (csrc/conv_ln.cuh); the fixed-order sum of
// per-tile partials (`sum_parts`) that K3 and K7 share; `Carve`, which K7
// and K6 lay their shared memory or scratch out with.
//
// BlockAcc<T, MaxTiles> holds one float32 (M x N) product tile of the
// block in registers, each warp owning whole 16 x 16 output tiles (tile
// t = warp + n_warps * i, i < MaxTiles), and accumulates
// A (M x Kc) . B (Kc x N) from staged shared-memory chunks:
//   * bf16: on the tensor cores through warp-level mma (nvcuda::wmma,
//     16x16x16 bf16 fragments, float32 accumulation), as K3 does;
//   * float32: plain FMA over 4 x 4 micro-tiles (TF32 would change the
//     numbers the float32 path is held to), the same capacity.
// A(m, k) = TA ? A[k * lda + m] : A[m * lda + k] and
// B(k, n) = TB ? B[n * ldb + k] : B[k * ldb + n], so the transposed
// products of a backward pass read the same staged tiles.  M, N and Kc are
// multiples of 16 and M * N <= MaxTiles * 256 * n_warps; the leading
// dimensions of bf16 tiles are multiples of 8 and of float32 tiles
// multiples of 4, with every region 128-byte aligned (the fragment loads
// need 32-byte aligned pointers).  Nothing here holds a barrier: the
// caller synchronises around the staging.
#pragma once

#include <mma.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace cpc {

using bf16 = __nv_bfloat16;

template <typename T, int MaxTiles>
struct BlockAcc;

template <int MaxTiles>
struct BlockAcc<bf16, MaxTiles> {
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>
      f[MaxTiles];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < MaxTiles; ++i)
      nvcuda::wmma::fill_fragment(f[i], 0.0f);
  }

  template <bool TA = false, bool TB = false>
  __device__ void mma(const bf16* A, int lda, const bf16* B, int ldb, int M,
                      int N, int Kc) {
    namespace wmma = nvcuda::wmma;
    using LA = typename std::conditional<TA, wmma::col_major,
                                         wmma::row_major>::type;
    using LB = typename std::conditional<TB, wmma::col_major,
                                         wmma::row_major>::type;
    const int warp = threadIdx.x >> 5;
    const int n_warps = blockDim.x >> 5;
    const int nt = N / 16;
#pragma unroll
    for (int i = 0; i < MaxTiles; ++i) {
      const int tile = warp + n_warps * i;
      if (tile < (M / 16) * nt) {
        const int m0 = (tile / nt) * 16;
        const int n0 = (tile - (tile / nt) * nt) * 16;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> b;
        for (int k = 0; k < Kc; k += 16) {
          wmma::load_matrix_sync(a, TA ? A + k * lda + m0 : A + m0 * lda + k,
                                 lda);
          wmma::load_matrix_sync(
              b, TB ? B + n0 * ldb + k : B + k * ldb + n0, ldb);
          wmma::mma_sync(f[i], a, b, f[i]);
        }
      }
    }
  }

  // C (M x N, float32, ldc) = the accumulated tile
  __device__ void store(float* C, int ldc, int M, int N) {
    const int warp = threadIdx.x >> 5;
    const int n_warps = blockDim.x >> 5;
    const int nt = N / 16;
#pragma unroll
    for (int i = 0; i < MaxTiles; ++i) {
      const int tile = warp + n_warps * i;
      if (tile < (M / 16) * nt)
        nvcuda::wmma::store_matrix_sync(
            C + (tile / nt) * 16 * ldc + (tile - (tile / nt) * nt) * 16,
            f[i], ldc, nvcuda::wmma::mem_row_major);
    }
  }
};

template <int MaxTiles>
struct BlockAcc<float, MaxTiles> {
  // micro-tile g = tid + blockDim * i of the (M / 4) x (N / 4) grid;
  // consecutive threads take consecutive column groups: B reads are
  // contiguous, A reads broadcasts
  static constexpr int kG = (MaxTiles + 1) / 2;
  float f[kG][4][4];

  __device__ void zero() {
#pragma unroll
    for (int g = 0; g < kG; ++g)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) f[g][i][j] = 0.0f;
  }

  template <bool TA = false, bool TB = false>
  __device__ void mma(const float* A, int lda, const float* B, int ldb,
                      int M, int N, int Kc) {
    const int ng = N / 4;
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const int grp = threadIdx.x + blockDim.x * g;
      if (grp < (M / 4) * ng) {
        const int m0 = (grp / ng) * 4;
        const int n0 = (grp - (grp / ng) * ng) * 4;
        for (int k = 0; k < Kc; ++k) {
          float a[4], b[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            a[i] = TA ? A[k * lda + m0 + i] : A[(m0 + i) * lda + k];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            b[j] = TB ? B[(n0 + j) * ldb + k] : B[k * ldb + n0 + j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) f[g][i][j] += a[i] * b[j];
        }
      }
    }
  }

  __device__ void store(float* C, int ldc, int M, int N) {
    const int ng = N / 4;
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const int grp = threadIdx.x + blockDim.x * g;
      if (grp < (M / 4) * ng) {
        const int m0 = (grp / ng) * 4;
        const int n0 = (grp - (grp / ng) * ng) * 4;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) C[(m0 + i) * ldc + n0 + j] = f[g][i][j];
      }
    }
  }
};

// 16 bytes from src to dst (both 16-byte aligned), or zeros.
template <typename T>
__device__ __forceinline__ void copy16(T* dst, const T* src) {
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
}
template <typename T>
__device__ __forceinline__ void zero16(T* dst) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
}

// dst[r * ldd + j] = src[r * lds + j] for r < valid, 0 for valid <= r < rows;
// j < cols, in 16-byte pieces (neighbouring threads on neighbouring pieces
// of a row): src and dst 16-byte aligned, and cols, ldd and lds multiples
// of 16 bytes' worth of elements, as every caller's shapes are.
template <typename T>
__device__ __forceinline__ void stage(T* dst, int ldd, const T* src,
                                      size_t lds, int rows, int cols,
                                      int valid) {
  constexpr int V = 16 / sizeof(T);
  const int vc = cols / V;
  for (int idx = threadIdx.x; idx < rows * vc; idx += blockDim.x) {
    const int r = idx / vc;
    const int j = (idx - r * vc) * V;
    if (r < valid)
      copy16(dst + r * ldd + j, src + (size_t)r * lds + j);
    else
      zero16(dst + r * ldd + j);
  }
}

// Carves a dynamic shared-memory block into 128-byte aligned regions.  The
// same code runs on the host with base 0 to size the block, so the launch
// and the kernel agree on the layout.  `reset` to an earlier offset lays a
// second set of regions over the first (a union of phases); `bytes` is the
// end of the longest.
struct Carve {
  uintptr_t base;
  size_t off = 0;
  size_t end = 0;
  __host__ __device__ explicit Carve(void* p)
      : base(reinterpret_cast<uintptr_t>(p)) {}
  template <typename U>
  __host__ __device__ U* take(size_t n) {
    U* r = reinterpret_cast<U*>(base + off);
    off += (n * sizeof(U) + 127) & ~static_cast<size_t>(127);
    end = end > off ? end : off;
    return r;
  }
  __host__ __device__ void reset(size_t to) { off = to; }
  __host__ __device__ size_t bytes() const { return end; }
};

// out[e] = sum over n < n_parts of part[n * n_elem + e], in the order of n,
// for e < n_elem and each of gridDim.y independent (part, out) slabs: the
// fixed-order second pass of the kernels' cross-block reductions.
static __global__ void sum_parts_kernel(const float* __restrict__ part,
                                        float* __restrict__ out, int n_parts,
                                        int n_elem) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_elem) return;
  const float* p = part + (size_t)blockIdx.y * n_parts * n_elem + e;
  float s = 0.0f;
  for (int n = 0; n < n_parts; ++n) s += p[(size_t)n * n_elem];
  out[(size_t)blockIdx.y * n_elem + e] = s;
}

inline cudaError_t sum_parts(const float* part, float* out, int n_parts,
                             int n_elem, int n_slabs, cudaStream_t stream) {
  const dim3 grid((n_elem + 255) / 256, n_slabs);
  sum_parts_kernel<<<grid, 256, 0, stream>>>(part, out, n_parts, n_elem);
  return cudaGetLastError();
}

}  // namespace cpc
