// Two helpers of the kernels' scratch: `Carve`, which K6 and K7 lay their
// shared memory or device scratch out with, and the fixed-order sum of
// per-tile partials (`sum_parts`) that K3 and K7 close their cross-block
// reductions with.
#pragma once

#include <cstddef>
#include <cstdint>

#include "common.cuh"

namespace cpc {

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
