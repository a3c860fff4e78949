// K3's tensor-core body (csrc/layer_tail_tc.cu), both directions in both
// dtypes, as the entry points of csrc/layer_tail_fwd.cu and
// csrc/layer_tail_bwd.cu call it.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

#include "dropout.cuh"

namespace cpc {
namespace tail_tc {

// dtype float32 or bf16; D a multiple of 8, F a multiple of 64 (bf16)
// or 32 (float32).
bool shapes_ok(int D, int F, int dtype);
// Row tiles of the D-wide products (the rows of vec_part).
int row_tiles(int M, int D);
// Shared memory of the largest block of either direction (the same in
// both dtypes).
size_t smem_bytes(int D);
// Device memory a direction (the forward's if fwd) needs beside the entry
// point's arguments.
size_t scratch_bytes(int K, int M, int D, int F, int dtype, bool fwd);

int launch_fwd(const void* x, const float* ln1w, const float* ln1b,
               const void* w1, const float* b1, const void* w2,
               const float* b2, const float* ln2w, const float* ln2b,
               void* out, void* scratch, int K, int M, int D, int F,
               float eps, cpc::Dropout drop, int dtype, cudaStream_t stream);

int launch_bwd(const void* x, const float* ln1w, const float* ln1b,
               const void* w1, const float* b1, const void* w2,
               const float* b2, const float* ln2w, const float* ln2b,
               const void* dout, void* dx, float* vec_part, float* vec_out,
               float* dw1, float* db1, float* dw2, void* scratch, int K,
               int M, int D, int F, float eps, cpc::Dropout drop, int dtype,
               cudaStream_t stream);

}  // namespace tail_tc
}  // namespace cpc
