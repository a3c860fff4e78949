// K5: causal attention with a dense bias, forward (the transformer AR).
//
// Replaces cpc_audio_tpu/ops/pallas/attention.py `_fwd_kernel` (called
// through `fused_causal_attention`).  Per row n of N = B * nheads:
//   s[i, j] = (q_i . k_j + bias[n, i, j]) / sqrt(dk),  j <= i
//   o_i     = round(softmax_j(s[i, :]) * dropout[i, :]) . v
// with q, k, v, o (N, S, dk) and bias (N, S, S), all in one dtype; round()
// is the rounding of the probabilities to that dtype, as the Pallas kernel
// casts them before its product with v.  Softmax statistics are float32.
// In training the probabilities are dropped after the normalising sum
// (dropout.cuh at the AR attention site, keyed on (layer, n, i * S + j)).
// The Pallas kernel pads S to the TPU's tiles; this one takes S as it is.
//
// Design: K2's forward (csrc/relpos_attention_fwd.cu) with the rel-pos
// gather replaced by a read of the bias row.  One block per n stages q, k
// and v as float32 in shared memory (k with a padded row stride so that
// lanes reading different keys hit different banks).  Each warp owns
// whole query rows: lanes stride over the keys (reading the bias row
// coalesced) to form the scores in a per-warp row buffer, warp reductions
// give the max and the sum, and then each lane produces one output
// column.  The (S, S) score tile never exists in full.
//
// What bounds it on an H100: at N = 256, S = 128, dk = 32 the call moves
// 16.8 MB in bf16 (the bias is half of it) for 0.27 GFLOP of causal
// products, so it is bound by memory; a block's ~54 KB of shared memory
// allows four per SM, and the row loop's latency is what a faster version
// would hide.
#include "common.cuh"
#include "dropout.cuh"

namespace {

constexpr int kThreads = 256;

size_t smem_bytes(int S, int dk) {
  return ((size_t)S * dk * 2 + (size_t)S * (dk + 1) +
          (size_t)(kThreads / 32) * S) *
         sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) causal_attention_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ bias, T* __restrict__ out, int S, int dk,
    float inv_sqrt, uint32_t w1_base, cpc::Dropout drop) {
  extern __shared__ float smem[];
  const int ldk = dk + 1;
  float* qs = smem;               // (S, dk)
  float* ks = qs + S * dk;        // (S, dk + 1)
  float* vs = ks + S * ldk;       // (S, dk)
  float* rows = vs + S * dk;      // (n_warps, S) per-warp probability rows

  const int n = blockIdx.x;
  const size_t base = (size_t)n * S * dk;
  for (int idx = threadIdx.x; idx < S * dk; idx += blockDim.x) {
    const int i = idx / dk;
    const int d = idx - i * dk;
    qs[idx] = cpc::to_f32(q[base + idx]);
    ks[i * ldk + d] = cpc::to_f32(k[base + idx]);
    vs[idx] = cpc::to_f32(v[base + idx]);
  }
  const uint32_t row_key =
      drop.active() ? cpc::dropout_row_key(drop.seed_word(),
                                           cpc::kSiteARAttention,
                                           w1_base + (uint32_t)n)
                    : 0u;
  __syncthreads();

  const T* bias_n = bias + (size_t)n * S * S;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  float* p = rows + warp * S;
  for (int i = warp; i < S; i += n_warps) {
    const float* qi = qs + i * dk;
    const T* bias_i = bias_n + (size_t)i * S;
    float mx = -INFINITY;
    for (int j = lane; j <= i; j += 32) {
      const float* kj = ks + j * ldk;
      float s = 0.0f;
      for (int d = 0; d < dk; ++d) s += qi[d] * kj[d];
      s = (s + cpc::to_f32(bias_i[j])) * inv_sqrt;
      p[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = cpc::warp_max(mx);
    float sum = 0.0f;
    for (int j = lane; j <= i; j += 32) {
      const float e = expf(p[j] - mx);
      p[j] = e;
      sum += e;
    }
    const float inv_sum = 1.0f / cpc::warp_sum(sum);
    for (int j = lane; j <= i; j += 32) {
      const float r =
          drop.active() ? cpc::dropout_factor(row_key, (uint32_t)(i * S + j),
                                              drop.threshold, drop.keep_scale)
                        : 1.0f;
      p[j] = cpc::round_to<T>(p[j] * inv_sum * r);
    }
    __syncwarp();
    for (int d = lane; d < dk; d += 32) {
      float o = 0.0f;
      for (int j = 0; j <= i; ++j) o += p[j] * vs[j * dk + d];
      out[base + (size_t)i * dk + d] = cpc::from_f32<T>(o);
    }
    __syncwarp();
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* bias,
           void* out, int N, int S, int dk, int layer, cpc::Dropout drop,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(S, dk);
  auto kernel = causal_attention_fwd_kernel<T>;
  cudaError_t err = cpc::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<N, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(bias),
      static_cast<T*>(out), S, dk, 1.0f / sqrtf(static_cast<float>(dk)),
      (uint32_t)layer * (uint32_t)N, drop);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory one block needs; the wrapper refuses shapes above the
// card's 227 KB.
extern "C" size_t cpc_causal_attention_fwd_smem(int S, int dk) {
  return smem_bytes(S, dk);
}

// q, k, v, out (N, S, dk) and bias (N, S, S) in `dtype`.
extern "C" int cpc_causal_attention_fwd(const void* q, const void* k,
                                        const void* v, const void* bias,
                                        void* out, int N, int S, int dk,
                                        int layer, const void* seed,
                                        unsigned int threshold,
                                        float keep_scale, int dtype,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cpc::Dropout drop{static_cast<const int64_t*>(seed), threshold,
                          keep_scale};
  if (dtype == cpc::kBFloat16)
    return launch<__nv_bfloat16>(q, k, v, bias, out, N, S, dk, layer, drop,
                                 s);
  if (dtype == cpc::kFloat32)
    return launch<float>(q, k, v, bias, out, N, S, dk, layer, drop, s);
  return (int)cudaErrorInvalidValue;
}
