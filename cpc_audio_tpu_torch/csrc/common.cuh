// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel takes its inputs in float32 or bfloat16 (a runtime dtype
// code chosen by the Python wrapper), converts to float32 on load and
// accumulates in float32, like the Pallas kernels it replaces.  Each C
// entry point launches on the stream it is given and returns
// cudaGetLastError(), which the wrapper turns into an exception.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cpc {

enum DType { kFloat32 = 0, kBFloat16 = 1 };

// Shared memory one block may opt into on an H100 (227 KB).
constexpr size_t kSmemLimit = 232448;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded through T and back: the kernels round an intermediate where
// the Pallas kernel casts it to the compute dtype.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Opt a kernel into more than 48 KB of dynamic shared memory.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace cpc
