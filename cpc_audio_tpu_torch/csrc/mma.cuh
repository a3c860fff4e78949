// Warp-level tensor-core building blocks for sm_90a, in raw PTX so that
// every fragment element has a known (row, column): mma.sync m16n8k16
// (bf16 inputs, float32 accumulation), ldmatrix and cp.async.
//
// Fragment layouts of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32
// (PTX ISA, "Matrix Fragments for mma.m16n8k16"), for lane = 4 g + t
// (g = lane >> 2, t = lane & 3); each 32-bit register holds two bf16, the
// lower column in the lower half:
//   A (16 x 16): a[0] = (g, 2t..2t+1),   a[1] = (g + 8, 2t..2t+1),
//                a[2] = (g, 2t+8..2t+9), a[3] = (g + 8, 2t+8..2t+9)
//   B (16 x 8):  b[0] = (k 2t..2t+1, n g),  b[1] = (k 2t+8..2t+9, n g)
//   C (16 x 8):  c[0] = (g, 2t), c[1] = (g, 2t+1), c[2] = (g + 8, 2t),
//                c[3] = (g + 8, 2t+1)
// So the accumulators of two neighbouring n8 tiles of a product are,
// packed to bf16, the A fragment of the next product over those 16
// columns (a_from_c), with no trip through shared memory.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace cpc {
namespace mma {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// c (16 x 8, float32) += a (16 x 16) . b (16 x 8)
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// A fragment of rows [r0, r0 + 16) x columns [k0, k0 + 16) of a row-major
// shared-memory tile with row stride ld (elements).
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* tile,
                                       int ld, int r0, int k0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(a, tile + (r0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}

// The same A fragment from a tile stored k-major (row k holds A[., k]
// along the rows, as y's rows are in y^T . dhp), through ldmatrix.trans.
__device__ __forceinline__ void load_a_kmajor(uint32_t a[4], const bf16* tile,
                                              int ld, int r0, int k0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4_trans(a, tile + (k0 + (lane & 7) + (lane >> 4) * 8) * ld + r0 +
                           ((lane >> 3) & 1) * 8);
}

// B fragments of the two n8 tiles n in [n0, n0 + 16), k in [k0, k0 + 16),
// from a tile stored n-major (row n holds B[., n] along k, as k^T's rows
// are k's): b[0], b[1] for n0..n0+7, b[2], b[3] for n0+8..n0+15.
__device__ __forceinline__ void load_b_nmajor(uint32_t b[4], const bf16* tile,
                                              int ld, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(b, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 +
                     ((lane >> 3) & 1) * 8);
}

// The B fragment of the one n8 tile [n0, n0 + 8), k in [k0, k0 + 16), from
// a tile stored n-major: b[0], b[1] as load_b_nmajor's first two (lanes
// 16-31 give addresses ldmatrix.x2 does not read).
__device__ __forceinline__ void load_b_nmajor_x2(uint32_t b[2],
                                                 const bf16* tile, int ld,
                                                 int n0, int k0) {
  const int lane = threadIdx.x & 31;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(b[0]), "=r"(b[1])
      : "r"(smem_addr(tile + (n0 + (lane & 7)) * ld + k0 +
                      ((lane >> 3) & 1) * 8)));
}

// The same two B fragments from a tile stored k-major (row k holds
// B[k, .] along n, as v's rows in p . v), through ldmatrix.trans.
__device__ __forceinline__ void load_b_kmajor(uint32_t b[4], const bf16* tile,
                                              int ld, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4_trans(b, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                           n0 + (lane >> 4) * 8);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragment over the 16 columns of accumulator tiles c0 (columns 0-7) and
// c1 (columns 8-15), each value rounded to bf16.
__device__ __forceinline__ void a_from_c(uint32_t a[4], const float* c0,
                                         const float* c1) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

__device__ __forceinline__ void split_pair(uint32_t& hi, uint32_t& lo,
                                           float x0, float x1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

// The two-term split x = hi + lo of the same accumulator tiles: hi =
// bf16(x), lo = bf16(x - hi).  hi . b + lo . b carries x to about 16
// significant bits, where a plain bf16 operand keeps 8: the backward
// products whose float32 operand the Pallas kernel multiplies unrounded.
__device__ __forceinline__ void split_from_c(uint32_t hi[4], uint32_t lo[4],
                                             const float* c0,
                                             const float* c1) {
  split_pair(hi[0], lo[0], c0[0], c0[1]);
  split_pair(hi[1], lo[1], c0[2], c0[3]);
  split_pair(hi[2], lo[2], c1[0], c1[1]);
  split_pair(hi[3], lo[3], c1[2], c1[3]);
}

// The three-plane split of the same accumulator tiles: a[0] = bf16(x),
// a[1] = bf16(x - a[0]), a[2] = bf16(x - a[0] - a[1]); the three carry x
// exactly (K5's float32 forward).
__device__ __forceinline__ void split3_from_c(uint32_t a[3][4],
                                              const float* c0,
                                              const float* c1) {
  const float* c[2] = {c0, c1};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float x0 = c[r >> 1][(r & 1) * 2], x1 = c[r >> 1][(r & 1) * 2 + 1];
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
      a[p][r] = *reinterpret_cast<const uint32_t*>(&h);
      x0 -= __low2float(h);
      x1 -= __high2float(h);
    }
  }
}

// 16-byte asynchronous copy global -> shared; with valid false the 16
// bytes are zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace mma
}  // namespace cpc
