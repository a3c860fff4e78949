// K2 backward: causal attention with Shaw relative positions.
//
// Replaces cpc_audio_tpu/ops/pallas/head_attention.py `_bwd_kernel`
// (called through `_fr_bwd`).  Recompute-style: per (k, batch row b,
// head h) the probabilities p are recomputed from q, k and krel, and with
// the forward's dropout factors r (regenerated from dropout.cuh, keyed on
// (k, b, h, i, j)):
//   dv_j    = sum_i round(p_ij r_ij) do_i
//   dp_ij   = (do_i . v_j) r_ij,   ds_ij = round(p_ij (dp_ij - sum_j p_ij dp_ij) / sqrt(dk))
//   dq_i    = sum_j ds_ij (k_j + krel[:, j - i + S - 1])
//   dk_j    = sum_i ds_ij q_i
//   dkrel[:, j - i + S - 1] += ds_ij q_i      (summed over b and h)
// where round() is the rounding to the input dtype that the Pallas kernel
// applies before its products.  The rel-pos adjoint is an index, not the
// TPU's `_unskew` lane gather: ds_ij meets krel column j - i + S - 1.
//
// Design: one block per (k, b, h) stages q, k, v, do and krel^T (float32)
// and keeps the whole (S, S) ds and round(p r) tiles in shared memory
// (183 KB at S = 116, dk = 32), so each is formed once and then read in
// three orders: by query row (dq, written at once), by key column (dk,
// dv) and by diagonal (one dkrel column per diagonal j - i).  Blocks run
// in parallel, so the TPU's dkrel accumulator revisited along a
// sequential grid becomes per-block partials (K, B*h, dk, S) that a
// second kernel sums over b and h in a fixed order: the result does not
// depend on block scheduling.
//
// What bounds it on an H100: the ds/p tiles limit a block to one per SM
// (8 warps), and at S = 116, dk = 32 the work per block is small
// (~2 MFLOP), so it is latency-bound on shared memory; the partials cost
// K*B*h*dk*S*4 bytes (45 MB at the train shapes) of writes and reads.
#include "common.cuh"
#include "dropout.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads) relpos_attention_bwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ krel, const T* __restrict__ dout,
    T* __restrict__ dq, T* __restrict__ dk_out, T* __restrict__ dv,
    float* __restrict__ dkrel_part, int n_batch, int S, int nheads, int dk,
    float inv_sqrt, cpc::Dropout drop) {
  extern __shared__ float smem[];
  const int ldk = dk + 1;
  float* qs = smem;               // (S, dk)
  float* dos = qs + S * dk;       // (S, dk)
  float* ks = dos + S * dk;       // (S, dk + 1)
  float* vs = ks + S * ldk;       // (S, dk + 1)
  float* krT = vs + S * ldk;      // (S, dk + 1): krT[r][d] = krel[k][d][r]
  float* DS = krT + S * ldk;      // (S, S) ds, rounded to T
  float* PD = DS + S * S;         // (S, S) p * r, rounded to T

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kk = blockIdx.z;
  const int D = nheads * dk;
  const size_t M = (size_t)n_batch * S;
  const size_t base = ((size_t)kk * M + (size_t)b * S) * D + (size_t)h * dk;
  const uint32_t row_key =
      drop.active() ? cpc::dropout_row_key(
                          drop.seed_word(), cpc::kSiteAttention,
                          (uint32_t)((kk * n_batch + b) * nheads + h))
                    : 0u;

  for (int idx = threadIdx.x; idx < S * dk; idx += blockDim.x) {
    const int i = idx / dk;
    const int d = idx - i * dk;
    const size_t off = base + (size_t)i * D + d;
    qs[i * dk + d] = cpc::to_f32(q[off]);
    dos[i * dk + d] = cpc::to_f32(dout[off]);
    ks[i * ldk + d] = cpc::to_f32(k[off]);
    vs[i * ldk + d] = cpc::to_f32(v[off]);
  }
  const T* kr_g = krel + (size_t)kk * dk * S;
  for (int idx = threadIdx.x; idx < dk * S; idx += blockDim.x) {
    const int d = idx / S;
    const int r = idx - d * S;
    krT[r * ldk + d] = cpc::to_f32(kr_g[idx]);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;

  // ---- by query row: p, dp, ds, round(p r); then dq_i ----
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
      const float r = drop.active()
          ? cpc::dropout_factor(row_key, (uint32_t)(i * S + j),
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
      const float r = drop.active()
          ? cpc::dropout_factor(row_key, (uint32_t)(i * S + j),
                                drop.threshold, drop.keep_scale)
          : 1.0f;
      dsr[j] = cpc::round_to<T>(p * (dsr[j] - c) * inv_sqrt);
      pdr[j] = cpc::round_to<T>(p * r);
    }
    __syncwarp();
    for (int d = lane; d < dk; d += 32) {
      float acc = 0.0f;
      for (int j = 0; j <= i; ++j)
        acc += dsr[j] * (ks[j * ldk + d] + krT[(j - i + S - 1) * ldk + d]);
      dq[base + (size_t)i * D + d] = cpc::from_f32<T>(acc);
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
      dk_out[base + (size_t)j * D + d] = cpc::from_f32<T>(a);
      dv[base + (size_t)j * D + d] = cpc::from_f32<T>(bsum);
    }
  }

  // ---- by diagonal: this block's part of dkrel[:, r], r = j - i + S - 1 ----
  float* part = dkrel_part +
                ((size_t)(kk * n_batch + b) * nheads + h) * dk * S;
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

// dkrel[k][e] = sum over the n_parts (b, h) partials, in a fixed order.
__global__ void dkrel_reduce_kernel(const float* __restrict__ part,
                                    float* __restrict__ dkrel, int n_parts,
                                    int n_elem) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int kk = blockIdx.y;
  if (e >= n_elem) return;
  const float* p = part + (size_t)kk * n_parts * n_elem + e;
  float s = 0.0f;
  for (int n = 0; n < n_parts; ++n) s += p[(size_t)n * n_elem];
  dkrel[(size_t)kk * n_elem + e] = s;
}

size_t smem_bytes(int S, int dk) {
  return ((size_t)S * dk * 2 + (size_t)S * (dk + 1) * 3 + (size_t)S * S * 2) *
         sizeof(float);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* krel,
           const void* dout, void* dq, void* dk_out, void* dv, float* part,
           float* dkrel, int K, int n_batch, int S, int nheads, int dk,
           cpc::Dropout drop, cudaStream_t stream) {
  const size_t smem = smem_bytes(S, dk);
  auto kernel = relpos_attention_bwd_kernel<T>;
  cudaError_t err = cpc::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nheads, n_batch, K);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(krel),
      static_cast<const T*>(dout), static_cast<T*>(dq),
      static_cast<T*>(dk_out), static_cast<T*>(dv), part, n_batch, S, nheads,
      dk, 1.0f / sqrtf(static_cast<float>(dk)), drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_elem = dk * S;
  const dim3 rgrid((n_elem + 255) / 256, K);
  dkrel_reduce_kernel<<<rgrid, 256, 0, stream>>>(part, dkrel,
                                                 n_batch * nheads, n_elem);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory one block needs; the wrapper refuses shapes above the
// card's 227 KB.
extern "C" size_t cpc_relpos_attention_bwd_smem(int S, int dk) {
  return smem_bytes(S, dk);
}

// q, k, v, dout and dq, dk, dv (K, n_batch*S, nheads*dk) and krel
// (K, dk, S) in `dtype`; dkrel (K, dk, S) float32; part is float32 scratch
// of K*n_batch*nheads*dk*S elements.
extern "C" int cpc_relpos_attention_bwd(
    const void* q, const void* k, const void* v, const void* krel,
    const void* dout, void* dq, void* dk, void* dv, void* dkrel, void* part,
    int K, int n_batch, int S, int nheads, int dkh, const void* seed,
    unsigned int threshold, float keep_scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cpc::Dropout drop{static_cast<const int64_t*>(seed), threshold,
                          keep_scale};
  float* p = static_cast<float*>(part);
  float* dr = static_cast<float*>(dkrel);
  if (dtype == cpc::kBFloat16)
    return launch<__nv_bfloat16>(q, k, v, krel, dout, dq, dk, dv, p, dr, K,
                                 n_batch, S, nheads, dkh, drop, s);
  if (dtype == cpc::kFloat32)
    return launch<float>(q, k, v, krel, dout, dq, dk, dv, p, dr, K, n_batch,
                         S, nheads, dkh, drop, s);
  return (int)cudaErrorInvalidValue;
}
