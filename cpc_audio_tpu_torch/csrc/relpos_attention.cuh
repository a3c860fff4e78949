// The per-head forward rows of causal attention with Shaw relative
// positions, K2's rows body (csrc/relpos_attention_fwd.cu, q/k/v read from
// device memory or staged; it runs past dk 256, where K2's tensor-core
// body, relpos_attention_tc.cuh, stops), and the pieces its backward
// (csrc/relpos_attention_bwd.cu) shares.  For one (k, batch row b, head
// h), with the operands staged in shared memory (as float32, or in the input dtype, or read in
// place where neither fits: K2 at long windows and wide heads):
//   s[i, j] = (q_i . k_j + q_i . krel[:, j - i + S - 1]) / sqrt(dk),  j <= i
//   o_i     = (softmax_j(s[i, :]) * dropout[i, :]) . v
// The rel-pos index j - i + S - 1 is the Pallas `_skew` (j - i - 1) mod S
// on the causal region, taken directly, so S needs no padding.  Softmax
// statistics are float32.  Dropout (dropout.cuh) is keyed on (k, b, h, i, j)
// through `row_key`, and drops the probabilities after the normalising
// sum, as the Pallas kernels drop p.
#pragma once

#include "common.cuh"
#include "dropout.cuh"

namespace cpc {

__device__ __forceinline__ uint32_t attention_row_key(const Dropout& drop,
                                                      int kk, int n_batch,
                                                      int b, int nheads,
                                                      int h) {
  return drop.active()
             ? dropout_row_key(drop.seed_word(), kSiteAttention,
                               (uint32_t)((kk * n_batch + b) * nheads + h))
             : 0u;
}

// A read-only matrix operand: element (r, c) at p[r * rs + c * cs], read
// as float32.  A staged operand is a view of shared memory (in float32 or
// in the input dtype), an operand read in place a view of device memory;
// each kernel fixes which at compile time, so that a shared-memory view is
// read with shared-memory loads.
template <typename E>
struct View {
  const E* p;
  int rs, cs;
  __device__ __forceinline__ float operator()(int r, int c) const {
    return to_f32(p[r * rs + c * cs]);
  }
};

// Forward: q (S, dk), k (S, dk), v (S, dk), kr (dk, S) = krel[k] as given,
// rows (n_warps, S) scratch.  Each warp owns whole query rows: lanes
// stride over the keys to form the scores into its row buffer, warp
// reductions give the max and the sum, and then each lane produces one
// output column, handed to store(i, d, o).  The (S, S) tile never exists
// in full.
template <typename VQ, typename VK, typename VV, typename VR, typename Store>
__device__ __forceinline__ void relpos_fwd_view_rows(
    VQ q, VK k, VV v, VR kr, float* __restrict__ rows, int S, int dk,
    float inv_sqrt, Dropout drop, uint32_t row_key, Store store) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  float* p = rows + warp * S;
  for (int i = warp; i < S; i += n_warps) {
    float mx = -INFINITY;
    for (int j = lane; j <= i; j += 32) {
      const int r = j - i + S - 1;
      float s = 0.0f;
      for (int d = 0; d < dk; ++d) s += q(i, d) * (k(j, d) + kr(d, r));
      s *= inv_sqrt;
      p[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int j = lane; j <= i; j += 32) {
      const float e = expf(p[j] - mx);
      p[j] = drop.active()
                 ? e * dropout_factor(row_key, (uint32_t)(i * S + j),
                                      drop.threshold, drop.keep_scale)
                 : e;
      sum += e;
    }
    const float inv_sum = 1.0f / warp_sum(sum);
    __syncwarp();
    for (int d = lane; d < dk; d += 32) {
      float o = 0.0f;
      for (int j = 0; j <= i; ++j) o += p[j] * v(j, d);
      store(i, d, o * inv_sum);
    }
    __syncwarp();
  }
}

}  // namespace cpc
