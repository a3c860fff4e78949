// K2: causal attention with Shaw relative positions, forward.
//
// Replaces cpc_audio_tpu/ops/pallas/head_attention.py `_fwd_kernel`
// (called through `fused_relpos_attention`).  Per (k, batch row b, head h):
//   s[i, j] = (q_i . k_j + q_i . krel[k][:, j - i + S - 1]) / sqrt(dk), j <= i
//   o_i     = (softmax_j(s[i, :]) * dropout[i, :]) . v
// q, k, v and o are in the natural (K, B*S, D = nheads*dk) layout of the
// K-batched projections; the head is the column block h*dk.  The rel-pos
// index j - i + S - 1 is the Pallas `_skew` (j - i - 1) mod S on the
// causal region, taken directly: there is no lane rotate to satisfy, so
// S needs no padding.  Softmax statistics are float32.  In training the
// probabilities are dropped (dropout.cuh, keyed on (k, b, h, i, j)) after
// the normalising sum, as the Pallas kernel drops p.
//
// Design: one block per (k, b, h) stages q, k, v and krel[k] for that head
// in shared memory as float32 (k with a padded row stride so that lanes
// reading different keys hit different banks) and runs the shared row
// body (relpos_attention.cuh).
//
// What bounds it on an H100: at S = 116, dk = 32 a block does ~0.7 MFLOP
// on ~60 KB of operands, so it is bound by the staging loads and by the
// number of resident blocks (about 64 KB of shared memory each, three
// per SM), not by arithmetic.
#include "relpos_attention.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void relpos_attention_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ krel, T* __restrict__ out, int n_batch, int S,
    int nheads, int dk, float inv_sqrt, cpc::Dropout drop) {
  extern __shared__ float smem[];
  const int ldk = dk + 1;
  float* qs = smem;               // (S, dk)
  float* ks = qs + S * dk;        // (S, dk + 1)
  float* vs = ks + S * ldk;       // (S, dk)
  float* kr = vs + S * dk;        // (dk, S), krel[k] as given
  float* rows = kr + dk * S;      // (n_warps, S) per-warp score rows

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kk = blockIdx.z;
  const int D = nheads * dk;
  const size_t M = (size_t)n_batch * S;
  const size_t base = ((size_t)kk * M + (size_t)b * S) * D + (size_t)h * dk;

  for (int idx = threadIdx.x; idx < S * dk; idx += blockDim.x) {
    const int i = idx / dk;
    const int d = idx - i * dk;
    const size_t off = base + (size_t)i * D + d;
    qs[i * dk + d] = cpc::to_f32(q[off]);
    ks[i * ldk + d] = cpc::to_f32(k[off]);
    vs[i * dk + d] = cpc::to_f32(v[off]);
  }
  const T* kr_g = krel + (size_t)kk * dk * S;
  for (int idx = threadIdx.x; idx < dk * S; idx += blockDim.x)
    kr[idx] = cpc::to_f32(kr_g[idx]);
  __syncthreads();

  cpc::relpos_fwd_rows(
      qs, ks, vs, kr, rows, S, dk, inv_sqrt, drop,
      cpc::attention_row_key(drop, kk, n_batch, b, nheads, h),
      [&](int i, int d, float o) {
        out[base + (size_t)i * D + d] = cpc::from_f32<T>(o);
      });
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* krel,
           void* out, int K, int n_batch, int S, int nheads, int dk,
           cpc::Dropout drop, cudaStream_t stream) {
  const size_t floats = (size_t)S * dk * 3 + (size_t)S + (size_t)dk * S +
                        (size_t)(kThreads / 32) * S;
  const size_t smem = floats * sizeof(float);
  auto kernel = relpos_attention_fwd_kernel<T>;
  cudaError_t err = cpc::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nheads, n_batch, K);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(krel),
      static_cast<T*>(out), n_batch, S, nheads, dk,
      1.0f / sqrtf(static_cast<float>(dk)), drop);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cpc_relpos_attention_fwd(const void* q, const void* k,
                                        const void* v, const void* krel,
                                        void* out, int K, int n_batch, int S,
                                        int nheads, int dk,
                                        const void* seed,
                                        unsigned int threshold,
                                        float keep_scale, int dtype,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cpc::Dropout drop{static_cast<const int64_t*>(seed), threshold,
                          keep_scale};
  if (dtype == cpc::kBFloat16)
    return launch<__nv_bfloat16>(q, k, v, krel, out, K, n_batch, S, nheads,
                                 dk, drop, s);
  if (dtype == cpc::kFloat32)
    return launch<float>(q, k, v, krel, out, K, n_batch, S, nheads, dk, drop,
                         s);
  return (int)cudaErrorInvalidValue;
}
