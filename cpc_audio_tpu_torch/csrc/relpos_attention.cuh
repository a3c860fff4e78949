// The per-head bodies of causal attention with Shaw relative positions.
// The forward rows are shared by K2's rows body (csrc/relpos_attention_fwd.cu,
// q/k/v read from device memory; it runs past dk 256, where K2's
// tensor-core body, relpos_attention_tc.cuh, stops) and K6
// (csrc/attention_block_fwd.cu, q/k/v projected in the kernel); the
// backward body is K6's
// (csrc/attention_block_bwd.cu), a copy of K2's kernel body with y added:
// K2's backward built on this shared function measured ~10 % slower than
// its own inline body on the H100 (same call, same 48 registers), so it
// keeps its own.  For one (k, batch row b, head h), with the operands
// staged in shared memory (as float32, or in the input dtype, or read in
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

// The same on float32 operands staged in shared memory: qs, vs (S, dk),
// ks (S, dk + 1), kr (dk, S).
template <typename Store>
__device__ __forceinline__ void relpos_fwd_rows(
    const float* __restrict__ qs, const float* __restrict__ ks,
    const float* __restrict__ vs, const float* __restrict__ kr,
    float* __restrict__ rows, int S, int dk, float inv_sqrt, Dropout drop,
    uint32_t row_key, Store store) {
  relpos_fwd_view_rows(View<float>{qs, dk, 1}, View<float>{ks, dk + 1, 1},
                       View<float>{vs, dk, 1}, View<float>{kr, S, 1}, rows,
                       S, dk, inv_sqrt, drop, row_key, store);
}

// Backward, recompute-style.  With p recomputed from q, k and krel, and
// the forward's dropout factors r regenerated:
//   dv_j    = sum_i round(p_ij r_ij) do_i
//   dp_ij   = (do_i . v_j) r_ij
//   ds_ij   = round(p_ij (dp_ij - sum_j p_ij dp_ij) / sqrt(dk))
//   dq_i    = sum_j ds_ij (k_j + krel[:, j - i + S - 1])
//   dk_j    = sum_i ds_ij q_i
//   dkrel[:, j - i + S - 1] += ds_ij q_i      (this block's part, to `part`)
//   y_i     = sum_j round(p_ij r_ij) v_j      (only with kWithY)
// where round() is the rounding to T that the Pallas kernels apply before
// their products.  The rel-pos adjoint is an index, not the TPU's `_unskew`
// lane gather.  Operands: qs, dos (S, dk); ks, vs, krT (S, dk + 1) with
// krT[r][d] = krel[k][d][r]; DS, PD (S, S) scratch, each formed once and
// then read by query row (dq, y), by key column (dk, dv) and by diagonal
// (dkrel).  Outputs are (.., D) rows at `base` (the head's column block of
// batch row b's first row); part is (dk, S) float32.
template <typename T, bool kWithY>
__device__ __forceinline__ void relpos_bwd_body(
    const float* __restrict__ qs, const float* __restrict__ dos,
    const float* __restrict__ ks, const float* __restrict__ vs,
    const float* __restrict__ krT, float* __restrict__ DS,
    float* __restrict__ PD, int S, int dk, float inv_sqrt, Dropout drop,
    uint32_t row_key, T* __restrict__ dq, T* __restrict__ dk_out,
    T* __restrict__ dv, T* __restrict__ y, size_t base, int D,
    float* __restrict__ part) {
  const int ldk = dk + 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;

  // ---- by query row: p, dp, ds, round(p r); then dq_i (and y_i) ----
  for (int i = warp; i < S; i += n_warps) {
    const float* qi = qs + i * dk;
    const float* doi = dos + i * dk;
    float* dsr = DS + i * S;
    float* pdr = PD + i * S;
    float mx = -INFINITY;
    for (int j = lane; j <= i; j += 32) {
      const float* kj = ks + j * ldk;
      const float* kr = krT + (j - i + S - 1) * ldk;
      float s = 0.0f;
      for (int d = 0; d < dk; ++d) s += qi[d] * (kj[d] + kr[d]);
      s *= inv_sqrt;
      dsr[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int j = lane; j <= i; j += 32) {
      const float e = expf(dsr[j] - mx);
      dsr[j] = e;
      sum += e;
    }
    const float inv_sum = 1.0f / warp_sum(sum);
    float pdp = 0.0f;
    for (int j = lane; j <= i; j += 32) {
      const float p = dsr[j] * inv_sum;
      const float* vj = vs + j * ldk;
      float dpd = 0.0f;
      for (int d = 0; d < dk; ++d) dpd += doi[d] * vj[d];
      const float r = drop.active()
          ? dropout_factor(row_key, (uint32_t)(i * S + j), drop.threshold,
                           drop.keep_scale)
          : 1.0f;
      const float dp = dpd * r;
      pdp += p * dp;
      pdr[j] = p;
      dsr[j] = dp;
    }
    const float c = warp_sum(pdp);
    for (int j = lane; j <= i; j += 32) {
      const float p = pdr[j];
      const float r = drop.active()
          ? dropout_factor(row_key, (uint32_t)(i * S + j), drop.threshold,
                           drop.keep_scale)
          : 1.0f;
      dsr[j] = round_to<T>(p * (dsr[j] - c) * inv_sqrt);
      pdr[j] = round_to<T>(p * r);
    }
    __syncwarp();
    for (int d = lane; d < dk; d += 32) {
      float acc = 0.0f;
      for (int j = 0; j <= i; ++j)
        acc += dsr[j] * (ks[j * ldk + d] + krT[(j - i + S - 1) * ldk + d]);
      dq[base + (size_t)i * D + d] = from_f32<T>(acc);
      if (kWithY) {
        float o = 0.0f;
        for (int j = 0; j <= i; ++j) o += pdr[j] * vs[j * ldk + d];
        y[base + (size_t)i * D + d] = from_f32<T>(o);
      }
    }
    __syncwarp();
  }
  __syncthreads();

  // ---- by key column: dk_j, dv_j ----
  for (int j = warp; j < S; j += n_warps) {
    for (int d = lane; d < dk; d += 32) {
      float a = 0.0f, bsum = 0.0f;
      for (int i = j; i < S; ++i) {
        a += DS[i * S + j] * qs[i * dk + d];
        bsum += PD[i * S + j] * dos[i * dk + d];
      }
      dk_out[base + (size_t)j * D + d] = from_f32<T>(a);
      dv[base + (size_t)j * D + d] = from_f32<T>(bsum);
    }
  }

  // ---- by diagonal: this block's part of dkrel[:, r], r = j - i + S - 1 ----
  for (int r = warp; r < S; r += n_warps) {
    const int delta = S - 1 - r;             // i - j
    for (int d = lane; d < dk; d += 32) {
      float a = 0.0f;
      for (int i = delta; i < S; ++i)
        a += DS[i * S + i - delta] * qs[i * dk + d];
      part[d * S + r] = a;
    }
  }
}

}  // namespace cpc
