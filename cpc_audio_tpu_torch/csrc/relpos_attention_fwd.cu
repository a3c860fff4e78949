// K2: causal attention with Shaw relative positions, forward.
//
// The rows body: it runs past dk 512 (--hiddenEncoder past 4096); at every
// dk up to 512 the tensor-core body of relpos_attention_tc_fwd.cu runs instead
// (ops/head_attention.py `fwd_body` / `bwd_body`).
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
// in shared memory (k with a padded row stride so that lanes reading
// different keys hit different banks) and runs the shared row body
// (relpos_attention.cuh).  Where the float32 operands do not fit (S 244,
// dk 64: 259 KB), the bf16 body stages them in bf16, which is exact (they
// are bf16 already; 134 KB there), and past that the operands are read in
// place from device memory (through L1/L2; slower, the same values).  The
// layout is a compile-time choice per shape family (`layout_of`), so that
// staged operands are read with shared-memory loads.
//
// What bounds it on an H100: at S = 116, dk = 32 a block does ~0.7 MFLOP
// on ~60 KB of operands, so it is bound by the staging loads and by the
// number of resident blocks (about 64 KB of shared memory each, three
// per SM), not by arithmetic.
#include "relpos_attention.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Where the operands live: float32 in shared memory; in T in shared
// memory (bf16 only); read in place from device memory.
enum Layout { kStaged, kStagedT, kInPlace };

__host__ __device__ size_t operand_elems(int S, int dk) {
  return (size_t)S * dk * 3 + (size_t)S + (size_t)dk * S;
}

__host__ __device__ size_t round16(size_t bytes) {
  return (bytes + 15) / 16 * 16;
}

size_t row_bytes(int S) { return (size_t)kWarps * S * sizeof(float); }

// Operands staged in TS, then the rows.
template <typename TS>
size_t staged_bytes(int S, int dk) {
  return round16(operand_elems(S, dk) * sizeof(TS)) + row_bytes(S);
}

template <typename T>
Layout layout_of(int S, int dk) {
  if (staged_bytes<float>(S, dk) <= cpc::kSmemLimit) return kStaged;
  if (sizeof(T) < sizeof(float) && staged_bytes<T>(S, dk) <= cpc::kSmemLimit)
    return kStagedT;
  return kInPlace;
}

template <typename T>
size_t smem_bytes(int S, int dk) {
  switch (layout_of<T>(S, dk)) {
    case kStaged:
      return staged_bytes<float>(S, dk);
    case kStagedT:
      return staged_bytes<T>(S, dk);
    default:
      return row_bytes(S);
  }
}

// TS: the staged operands' type (float, or T); IN_PLACE: no staging.
template <typename T, typename TS, bool IN_PLACE>
__global__ void relpos_attention_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ krel, T* __restrict__ out, int n_batch, int S,
    int nheads, int dk, float inv_sqrt, cpc::Dropout drop) {
  extern __shared__ __align__(16) float smem[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kk = blockIdx.z;
  const int D = nheads * dk;
  const size_t M = (size_t)n_batch * S;
  const size_t base = ((size_t)kk * M + (size_t)b * S) * D + (size_t)h * dk;
  const T* kr_g = krel + (size_t)kk * dk * S;
  const uint32_t row_key =
      cpc::attention_row_key(drop, kk, n_batch, b, nheads, h);
  auto store = [&](int i, int d, float o) {
    out[base + (size_t)i * D + d] = cpc::from_f32<T>(o);
  };

  if constexpr (IN_PLACE) {
    cpc::relpos_fwd_view_rows(
        cpc::View<T>{q + base, D, 1}, cpc::View<T>{k + base, D, 1},
        cpc::View<T>{v + base, D, 1}, cpc::View<T>{kr_g, S, 1}, smem, S, dk,
        inv_sqrt, drop, row_key, store);
  } else {
    const int ldk = dk + 1;
    TS* qs = reinterpret_cast<TS*>(smem);   // (S, dk)
    TS* ks = qs + S * dk;                   // (S, dk + 1)
    TS* vs = ks + S * ldk;                  // (S, dk)
    TS* kr = vs + S * dk;                   // (dk, S), krel[k] as given
    // (n_warps, S) per-warp score rows
    float* rows = reinterpret_cast<float*>(
        smem + round16(operand_elems(S, dk) * sizeof(TS)) / sizeof(float));
    for (int idx = threadIdx.x; idx < S * dk; idx += blockDim.x) {
      const int i = idx / dk;
      const int d = idx - i * dk;
      const size_t off = base + (size_t)i * D + d;
      qs[i * dk + d] = cpc::from_f32<TS>(cpc::to_f32(q[off]));
      ks[i * ldk + d] = cpc::from_f32<TS>(cpc::to_f32(k[off]));
      vs[i * dk + d] = cpc::from_f32<TS>(cpc::to_f32(v[off]));
    }
    for (int idx = threadIdx.x; idx < dk * S; idx += blockDim.x)
      kr[idx] = cpc::from_f32<TS>(cpc::to_f32(kr_g[idx]));
    __syncthreads();
    cpc::relpos_fwd_view_rows(
        cpc::View<TS>{qs, dk, 1}, cpc::View<TS>{ks, ldk, 1},
        cpc::View<TS>{vs, dk, 1}, cpc::View<TS>{kr, S, 1}, rows, S, dk,
        inv_sqrt, drop, row_key, store);
  }
}

template <typename T, typename TS, bool IN_PLACE>
cudaError_t launch_body(const void* q, const void* k, const void* v,
                        const void* krel, void* out, int K, int n_batch,
                        int S, int nheads, int dk, size_t smem,
                        cpc::Dropout drop, cudaStream_t stream) {
  auto kernel = relpos_attention_fwd_kernel<T, TS, IN_PLACE>;
  cudaError_t err = cpc::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(nheads, n_batch, K);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(krel),
      static_cast<T*>(out), n_batch, S, nheads, dk,
      1.0f / sqrtf(static_cast<float>(dk)), drop);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* krel,
           void* out, int K, int n_batch, int S, int nheads, int dk,
           cpc::Dropout drop, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(S, dk);
  if (S <= 0 || dk <= 0 || smem > cpc::kSmemLimit)
    return (int)cudaErrorInvalidValue;
  switch (layout_of<T>(S, dk)) {
    case kStaged:
      return (int)launch_body<T, float, false>(q, k, v, krel, out, K, n_batch,
                                               S, nheads, dk, smem, drop,
                                               stream);
    case kStagedT:
      if constexpr (sizeof(T) < sizeof(float))
        return (int)launch_body<T, T, false>(q, k, v, krel, out, K, n_batch,
                                             S, nheads, dk, smem, drop,
                                             stream);
      return (int)cudaErrorInvalidValue;
    default:
      return (int)launch_body<T, T, true>(q, k, v, krel, out, K, n_batch, S,
                                          nheads, dk, smem, drop, stream);
  }
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
