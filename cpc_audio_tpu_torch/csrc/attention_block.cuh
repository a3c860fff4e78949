// Pieces shared by the K6 forward and backward
// (csrc/attention_block_{fwd,bwd}.cu).
#pragma once

#include "relpos_attention.cuh"
#include "tile_mm.cuh"

namespace cpc {

// A block's (SP, 3 dk) projection tile in registers: at most 128 x 96,
// 3 tiles of 16 x 16 a warp of 16.
template <typename T>
using ProjAcc = BlockAcc<T, 4>;

// dst (rows, 3 dk; ld) = rows k0 .. k0 + rows - 1 of head h's columns
// h dk .. (h+1) dk of [Wq | Wk | Wv][k], with w_off = k D D.  dk % 16 == 0
// and 16-byte aligned weights, so each piece lies inside one slice.
template <typename T>
__device__ __forceinline__ void stage_qkv(T* dst, int ld, const T* wq,
                                          const T* wk, const T* wv,
                                          size_t w_off, int D, int dk,
                                          int h, int k0, int rows) {
  constexpr int V = 16 / sizeof(T);
  const int n3v = 3 * dk / V;
  for (int idx = threadIdx.x; idx < rows * n3v; idx += blockDim.x) {
    const int r = idx / n3v;
    const int j = (idx - r * n3v) * V;
    const int which = j / dk;
    const T* w = which == 0 ? wq : (which == 1 ? wk : wv);
    copy16(dst + r * ld + j,
           w + w_off + (size_t)(k0 + r) * D + h * dk + (j - which * dk));
  }
}

}  // namespace cpc
