// K8: row scatter-add of sorted updates (the negatives' gather backward).
//
// Replaces cpc_audio_tpu/ops/pallas/scatter_add.py `_kernel` (called
// through `_scatter_sorted` and the public `scatter_add_rows`).  It
// computes out (R, C) float32 = sum_j onehot(keys[j]) * updates[j] for
// updates (J, C) in float32 or bfloat16.  The wrapper (ops/scatter_add.py)
// sorts the keys stably once and hands the kernel
//   order   (J,)    int32: update rows by ascending key, ties by index,
//   offsets (R + 1,) int32: offsets[r] = number of keys below r,
// so the updates of destination row r are updates[order[i]] for
// offsets[r] <= i < offsets[r + 1].  Indices are int32: J and R stay below
// 2^31 (at the train shapes J = 475,136 and R = 4096).
//
// Design: one warp per destination row.  It walks its run of `order` 32 indices
// at a time (one coalesced load, then broadcast by shuffle), and for each index
// reads the update row in place, 16 bytes a lane (a 512 B bf16 row of C = 256
// is one load per lane), so the sorted copy updates[order] is never
// materialised.  Up to eight rows are loaded before any is added, to keep loads
// in flight, and they are added in sorted order into float32 registers: the sum
// of each row is taken in a fixed order, so the kernel is bit-reproducible,
// with no atomics and no read-modify-write of `out`.  Each row is written once;
// a row with no update is written 0.  A row past 4096 bytes (float32 past C
// 1024, bf16 past 2048) is walked in pieces of 4096 bytes, one warp each (the
// grid's y), each walking the row's whole run of `order`.  There is no capacity
// limit (the Pallas kernel's window and its fallback to the XLA scatter have no
// counterpart): a row with many updates only takes its warp longer.
//
// What bounds it on an H100: at the train shapes it reads 243 MB of bf16
// updates and 1.9 MB of `order` and writes 4.2 MB, for 0.27 GFLOP of adds,
// so it is bound by memory (~0.075 ms at 3.35 TB/s).  Its rows are read
// in a random order, 512 B at a time; the warps of a block share no data.
// The time of a warp follows its row's count (116 updates on average with
// uniform keys), so a skewed distribution is slow but right.
#include "common.cuh"

#include <cstdint>

namespace {

constexpr int kWarps = 8;  // warps (destination rows) per block

__device__ __forceinline__ void add_chunk(float* acc, const uint4& v,
                                          float) {
  acc[0] += __uint_as_float(v.x);
  acc[1] += __uint_as_float(v.y);
  acc[2] += __uint_as_float(v.z);
  acc[3] += __uint_as_float(v.w);
}

__device__ __forceinline__ void add_chunk(float* acc, const uint4& v,
                                          __nv_bfloat16) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // a bf16 is the high half of a float32: exact widening
    acc[2 * i] += __uint_as_float(w[i] << 16);
    acc[2 * i + 1] += __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

constexpr int kMaxChunks = 256;   // 16-byte chunks of a row a warp adds

// NCH: 16-byte chunks a lane owns in a row; U: rows loaded before adding.
// Rows past kMaxChunks chunks (4096 bytes) are walked in pieces of that
// many: the warp of blockIdx.y adds chunks [kMaxChunks blockIdx.y,
// kMaxChunks (blockIdx.y + 1)) of its row.
template <typename T, int NCH>
__global__ void __launch_bounds__(kWarps * 32) scatter_add_kernel(
    const T* __restrict__ updates, const int* __restrict__ order,
    const int* __restrict__ offsets, float* __restrict__ out, int R,
    int n_chunks) {
  constexpr int E = 16 / sizeof(T);  // elements in a 16-byte chunk
  constexpr int U = 8 / NCH;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= R) return;
  const int lane = threadIdx.x & 31;
  const int c0 = blockIdx.y * kMaxChunks;   // the piece's first chunk
  const int start = offsets[row];
  const int end = offsets[row + 1];
  const uint4* src = reinterpret_cast<const uint4*>(updates);

  float acc[NCH][E];
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[c][e] = 0.0f;

  for (int base = start; base < end; base += 32) {
    const int n = min(32, end - base);
    const int mine = lane < n ? order[base + lane] : 0;
    for (int i = 0; i < n; i += U) {
      uint4 v[U][NCH];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = __shfl_sync(0xffffffffu, mine, (i + u) & 31);
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          const int chunk = c0 + lane + 32 * c;
          v[u][c] = (i + u < n && chunk < n_chunks)
                        ? __ldg(src + (size_t)j * n_chunks + chunk)
                        : make_uint4(0u, 0u, 0u, 0u);
        }
      }
      // in sorted order: the same sum, bit for bit, on every run
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int c = 0; c < NCH; ++c)
          if (i + u < n) add_chunk(acc[c], v[u][c], T());
    }
  }

  float4* dst = reinterpret_cast<float4*>(out + (size_t)row * n_chunks * E);
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int chunk = c0 + lane + 32 * c;
    if (chunk < n_chunks) {
#pragma unroll
      for (int q = 0; q < E / 4; ++q)
        dst[chunk * (E / 4) + q] = make_float4(
            acc[c][4 * q], acc[c][4 * q + 1], acc[c][4 * q + 2],
            acc[c][4 * q + 3]);
    }
  }
}

template <typename T>
int launch(const void* updates, const int* order, const int* offsets,
           float* out, int R, int C, cudaStream_t stream) {
  const int n_chunks = C * (int)sizeof(T) / 16;
  const dim3 grid((R + kWarps - 1) / kWarps,
                  (n_chunks + kMaxChunks - 1) / kMaxChunks);
  const dim3 block(kWarps * 32);
  const T* u = static_cast<const T*>(updates);
  if (n_chunks <= 32)
    scatter_add_kernel<T, 1><<<grid, block, 0, stream>>>(u, order, offsets,
                                                         out, R, n_chunks);
  else if (n_chunks <= 64)
    scatter_add_kernel<T, 2><<<grid, block, 0, stream>>>(u, order, offsets,
                                                         out, R, n_chunks);
  else if (n_chunks <= 128)
    scatter_add_kernel<T, 4><<<grid, block, 0, stream>>>(u, order, offsets,
                                                         out, R, n_chunks);
  else   // float32 rows of C = 768 and 1024, and pieces of wider ones
    scatter_add_kernel<T, 8><<<grid, block, 0, stream>>>(u, order, offsets,
                                                         out, R, n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// updates (J, C) in `dtype`, 16-byte aligned, C * itemsize a positive
// multiple of 16; order (J,) and offsets (R + 1,) int32; out (R, C)
// float32.  R > 0.
extern "C" int cpc_scatter_add(const void* updates, const void* order,
                               const void* offsets, void* out, int R, int C,
                               int dtype, void* stream) {
  if (C <= 0 || C * (dtype == cpc::kFloat32 ? 4 : 2) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* o = static_cast<const int*>(order);
  const int* off = static_cast<const int*>(offsets);
  float* dst = static_cast<float*>(out);
  if (dtype == cpc::kBFloat16)
    return launch<__nv_bfloat16>(updates, o, off, dst, R, C, s);
  if (dtype == cpc::kFloat32) return launch<float>(updates, o, off, dst, R, C, s);
  return (int)cudaErrorInvalidValue;
}
