// K5 backward: causal attention with a dense bias (the transformer AR).
//
// Replaces cpc_audio_tpu/ops/pallas/attention.py `_bwd_kernel` (called
// through `_fused_bwd`).  Recompute-style: per row n of N = B * nheads the
// probabilities p are recomputed from q, k and the bias, and with the
// forward's dropout factors r (regenerated from dropout.cuh, keyed on
// (layer, n, i * S + j)):
//   dv_j    = sum_i p_ij r_ij do_i
//   dp_ij   = (do_i . v_j) r_ij,   ds_ij = p_ij (dp_ij - sum_j p_ij dp_ij) / sqrt(dk)
//   dq_i    = sum_j ds_ij k_j,     dk_j = sum_i ds_ij q_i,   dbias_ij = ds_ij
// all in float32 until the outputs are written in the input dtype, as the
// Pallas kernel does.  dbias is written in full: exactly 0 wherever
// j > i.  The caller builds the Shaw bias by the zero-pad/reshape skew,
// whose masked cells hold q . Krelpos values of other positions, so any
// other value there would flow into dq and dKrelpos.
//
// Design: one block per n stages q, do, k and v (float32) and keeps the
// whole (S, S) ds and p * r tiles in shared memory (198 KB at S = 128,
// dk = 32, within the 227 KB a block may opt into), so each is formed
// once, by query row (with dq_i and the dbias row written at once), and
// then read by key column (dk_j, dv_j).  dbias belongs to one row n, so
// unlike K2's dKrelpos there is no reduction across blocks.
//
// What bounds it on an H100: the call moves 31.5 MB in bf16 for 0.67
// GFLOP of causal products, so it is bound by memory; the ds and p tiles
// limit a block to one per SM (8 warps), so at N = 256 it runs in two
// waves over the 132 SMs, latency-bound on shared memory.
#include "common.cuh"
#include "dropout.cuh"

namespace {

constexpr int kThreads = 256;

size_t smem_bytes(int S, int dk) {
  return ((size_t)S * dk * 2 + (size_t)S * (dk + 1) * 2 + (size_t)S * S * 2) *
         sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) causal_attention_bwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ bias, const T* __restrict__ dout,
    T* __restrict__ dq, T* __restrict__ dk_out, T* __restrict__ dv,
    T* __restrict__ dbias, int S, int dk, float inv_sqrt, uint32_t w1_base,
    cpc::Dropout drop) {
  extern __shared__ float smem[];
  const int ldk = dk + 1;
  float* qs = smem;               // (S, dk)
  float* dos = qs + S * dk;       // (S, dk)
  float* ks = dos + S * dk;       // (S, dk + 1)
  float* vs = ks + S * ldk;       // (S, dk + 1)
  float* DS = vs + S * ldk;       // (S, S) ds
  float* PD = DS + S * S;         // (S, S) p * r

  const int n = blockIdx.x;
  const size_t base = (size_t)n * S * dk;
  const uint32_t row_key =
      drop.active() ? cpc::dropout_row_key(drop.seed_word(),
                                           cpc::kSiteARAttention,
                                           w1_base + (uint32_t)n)
                    : 0u;
  for (int idx = threadIdx.x; idx < S * dk; idx += blockDim.x) {
    const int i = idx / dk;
    const int d = idx - i * dk;
    qs[idx] = cpc::to_f32(q[base + idx]);
    dos[idx] = cpc::to_f32(dout[base + idx]);
    ks[i * ldk + d] = cpc::to_f32(k[base + idx]);
    vs[i * ldk + d] = cpc::to_f32(v[base + idx]);
  }
  __syncthreads();

  const T* bias_n = bias + (size_t)n * S * S;
  T* dbias_n = dbias + (size_t)n * S * S;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;

  // ---- by query row: p, dp, ds, p * r; the dbias row and dq_i ----
  for (int i = warp; i < S; i += n_warps) {
    const float* qi = qs + i * dk;
    const float* doi = dos + i * dk;
    const T* bias_i = bias_n + (size_t)i * S;
    float* dsr = DS + i * S;
    float* pdr = PD + i * S;
    float mx = -INFINITY;
    for (int j = lane; j <= i; j += 32) {
      const float* kj = ks + j * ldk;
      float s = 0.0f;
      for (int d = 0; d < dk; ++d) s += qi[d] * kj[d];
      s = (s + cpc::to_f32(bias_i[j])) * inv_sqrt;
      dsr[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = cpc::warp_max(mx);
    float sum = 0.0f;
    for (int j = lane; j <= i; j += 32) {
      const float e = expf(dsr[j] - mx);
      dsr[j] = e;
      sum += e;
    }
    const float inv_sum = 1.0f / cpc::warp_sum(sum);
    float pdp = 0.0f;
    for (int j = lane; j <= i; j += 32) {
      const float p = dsr[j] * inv_sum;
      const float* vj = vs + j * ldk;
      float dpd = 0.0f;
      for (int d = 0; d < dk; ++d) dpd += doi[d] * vj[d];
      const float r =
          drop.active() ? cpc::dropout_factor(row_key, (uint32_t)(i * S + j),
                                              drop.threshold, drop.keep_scale)
                        : 1.0f;
      const float dp = dpd * r;
      pdp += p * dp;
      pdr[j] = p;
      dsr[j] = dp;
    }
    const float c = cpc::warp_sum(pdp);
    for (int j = lane; j <= i; j += 32) {
      const float p = pdr[j];
      const float r =
          drop.active() ? cpc::dropout_factor(row_key, (uint32_t)(i * S + j),
                                              drop.threshold, drop.keep_scale)
                        : 1.0f;
      const float ds = p * (dsr[j] - c) * inv_sqrt;
      dsr[j] = ds;
      pdr[j] = p * r;
      dbias_n[(size_t)i * S + j] = cpc::from_f32<T>(ds);
    }
    for (int j = i + 1 + lane; j < S; j += 32)
      dbias_n[(size_t)i * S + j] = cpc::from_f32<T>(0.0f);
    __syncwarp();
    for (int d = lane; d < dk; d += 32) {
      float acc = 0.0f;
      for (int j = 0; j <= i; ++j) acc += dsr[j] * ks[j * ldk + d];
      dq[base + (size_t)i * dk + d] = cpc::from_f32<T>(acc);
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
      dk_out[base + (size_t)j * dk + d] = cpc::from_f32<T>(a);
      dv[base + (size_t)j * dk + d] = cpc::from_f32<T>(bsum);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* bias,
           const void* dout, void* dq, void* dk_out, void* dv, void* dbias,
           int N, int S, int dk, int layer, cpc::Dropout drop,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(S, dk);
  auto kernel = causal_attention_bwd_kernel<T>;
  cudaError_t err = cpc::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<N, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(bias),
      static_cast<const T*>(dout), static_cast<T*>(dq),
      static_cast<T*>(dk_out), static_cast<T*>(dv), static_cast<T*>(dbias), S,
      dk, 1.0f / sqrtf(static_cast<float>(dk)), (uint32_t)layer * (uint32_t)N,
      drop);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory one block needs; the wrapper refuses shapes above the
// card's 227 KB.
extern "C" size_t cpc_causal_attention_bwd_smem(int S, int dk) {
  return smem_bytes(S, dk);
}

// q, k, v, dout and dq, dk, dv (N, S, dk), bias and dbias (N, S, S), all
// in `dtype`.
extern "C" int cpc_causal_attention_bwd(
    const void* q, const void* k, const void* v, const void* bias,
    const void* dout, void* dq, void* dk, void* dv, void* dbias, int N,
    int S, int dkh, int layer, const void* seed, unsigned int threshold,
    float keep_scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cpc::Dropout drop{static_cast<const int64_t*>(seed), threshold,
                          keep_scale};
  if (dtype == cpc::kBFloat16)
    return launch<__nv_bfloat16>(q, k, v, bias, dout, dq, dk, dv, dbias, N,
                                 S, dkh, layer, drop, s);
  if (dtype == cpc::kFloat32)
    return launch<float>(q, k, v, bias, dout, dq, dk, dv, dbias, N, S, dkh,
                         layer, drop, s);
  return (int)cudaErrorInvalidValue;
}
