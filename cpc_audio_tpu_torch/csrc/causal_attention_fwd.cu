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
// Shapes: dk <= 128, a multiple of 8 in bf16; any S (the wrapper's gate
// keeps JAX's S <= 512).
//
// Two bodies:
//   * bf16 (the train path): tensor cores.  One block of 4 warps per
//     (64-query tile, n), each warp owning 16 query rows.  The q tile is
//     staged once; k, v and the causal chunk of the bias for each key tile
//     up to the diagonal are staged with cp.async into a double buffer
//     (tile t + 1 in flight while t is used), so no block reads bias above
//     the diagonal.  q.k^T and p.v run on mma.sync m16n8k16 (bf16 in,
//     float32 sums, causal_attention.cuh); the bias, the mask, the running
//     (online) max and sum, the dropout factor and the rounding happen in
//     registers, and the rounded probability accumulators are the A
//     operand of p.v directly.  Registers stay flat in S: one key tile of
//     scores at a time, the output rescaled as the running max moves.  The
//     one departure from the two-pass Pallas softmax: a probability is
//     rounded to bf16 as exp(s - running max) * r and divided by the row
//     sum after p.v, so its rounding can differ from round(p * r) by one
//     ulp, well inside the output's own bf16 rounding.
//   * float32: exact FMA loops (TF32 would change the numbers), one block
//     of 8 warps per n, each warp owning whole query rows: lanes stride
//     over the keys to form the scores in a per-warp row buffer, warp
//     reductions give the max and the sum, then each lane produces output
//     columns.  q, k and v are staged as float32 in shared memory where
//     they fit; past that (S * dk large) the same loops read them from
//     device memory through the L1 cache.
//
// What bounds it on an H100: at N = 256, S = 128, dk = 32 the call moves
// 16.8 MB in bf16 (the bias's causal half is half of it) for 0.27 GFLOP of
// causal products: memory, 5 us at 3.35 TB/s.  The bf16 body's 512
// blocks of ~43 KB (five resident per SM) keep loads in flight across
// blocks; each block waits on its own tile loads.
#include "causal_attention.cuh"

namespace {

using cpc::k5::bf16;
namespace k5 = cpc::k5;

// ---------------------------------------------------------------------------
// bf16 body: tensor cores
// ---------------------------------------------------------------------------

template <int DKP>
constexpr size_t mma_smem_bytes() {
  // q, two (k, v) buffers, two bias buffers
  return ((size_t)5 * k5::tile_elems<DKP>() + 2 * k5::bias_elems()) *
         sizeof(bf16);
}

template <int DKP>
__global__ void __launch_bounds__(k5::kThreads) causal_attention_fwd_mma(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ bias,
    bf16* __restrict__ out, int S, int dk, float inv_sqrt, uint32_t w1_base,
    cpc::Dropout drop) {
  constexpr int TE = k5::tile_elems<DKP>();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + TE;              // 2 buffers
  bf16* Vs = Ks + 2 * TE;          // 2 buffers
  bf16* Bs = Vs + 2 * TE;          // 2 buffers of (64, kLdb)

  const int n = blockIdx.y;
  const int qt = gridDim.x - 1 - blockIdx.x;   // longest rows first
  const int q0 = qt * k5::kTile;
  const size_t base = (size_t)n * S * dk;
  const bf16* bias_n = bias + (size_t)n * S * S;
  const int warp = threadIdx.x >> 5;
  const int r0 = q0 + warp * 16;               // the warp's first row
  const uint32_t row_key =
      drop.active() ? cpc::dropout_row_key(drop.seed_word(),
                                           cpc::kSiteARAttention,
                                           w1_base + (uint32_t)n)
                    : 0u;

  k5::stage_rows<DKP>(Qs, q + base, q0, S, dk);
  k5::stage_rows<DKP>(Ks, k + base, 0, S, dk);
  k5::stage_rows<DKP>(Vs, v + base, 0, S, dk);
  k5::stage_bias(Bs, bias_n, q0, 0, S);
  cpc::mma::cp_async_commit();

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float o[DKP / 8][4];
#pragma unroll
  for (int nt = 0; nt < DKP / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.0f;

  for (int kt = 0; kt <= qt; ++kt) {
    const int buf = kt & 1;
    // n8 tiles of keys that can be <= one of the warp's rows; the dropout
    // bits need no data, so they are drawn while the tile's copy is in
    // flight
    const int n_hi = kt == qt ? 2 * warp + 2 : 8;
    const uint32_t keep =
        k5::keep_bits(drop, row_key, r0, kt * k5::kTile, 0, n_hi, S);
    if (kt < qt) {   // next key tile into the other buffer
      const int nb = buf ^ 1, k0 = (kt + 1) * k5::kTile;
      k5::stage_rows<DKP>(Ks + nb * TE, k + base, k0, S, dk);
      k5::stage_rows<DKP>(Vs + nb * TE, v + base, k0, S, dk);
      k5::stage_bias(Bs + nb * k5::bias_elems(), bias_n, q0, k0, S);
      cpc::mma::cp_async_commit();
      cpc::mma::cp_async_wait<1>();
    } else {
      cpc::mma::cp_async_wait<0>();
    }
    __syncthreads();

    float s[8][4];
    k5::rows_dot_rows<DKP>(s, Qs, warp * 16, Ks + buf * TE, 0, n_hi);
    const bf16* Bb = Bs + buf * k5::bias_elems();
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ri = warp * 16 + k5::row_of(e), cj = k5::col_of(nt, e);
        const int i = q0 + ri, j = kt * k5::kTile + cj;
        const float x =
            j <= i ? (s[nt][e] + __bfloat162float(Bb[ri * k5::kLdb + cj])) *
                         inv_sqrt
                   : -INFINITY;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float rescale[2], ls[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = k5::quad_max(mx[h]);   // finite: key 0 <= every row
      rescale[h] = expf(m[h] - mx[h]);
      m[h] = mx[h];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] - m[e >> 1]);
        ls[e >> 1] += p;
        s[nt][e] = p * k5::kept_factor(drop, keep, nt, e);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * rescale[h] + k5::quad_sum(ls[h]);
#pragma unroll
    for (int nt = 0; nt < DKP / 8; ++nt) {
      o[nt][0] *= rescale[0];
      o[nt][1] *= rescale[0];
      o[nt][2] *= rescale[1];
      o[nt][3] *= rescale[1];
    }
    k5::acc_times_rows<DKP, false>(o, s, Vs + buf * TE, 0, n_hi / 2);
    __syncthreads();   // buffer `buf` is restaged by iteration kt + 1
  }
  const float inv_l[2] = {1.0f / l[0], 1.0f / l[1]};
  k5::store_rows<DKP>(out + base, o, r0, S, dk, inv_l);
}

template <int DKP>
int launch_mma(const void* q, const void* k, const void* v, const void* bias,
               void* out, int N, int S, int dk, int layer, cpc::Dropout drop,
               cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<DKP>();
  auto kernel = causal_attention_fwd_mma<DKP>;
  cudaError_t err = cpc::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + k5::kTile - 1) / k5::kTile, N);
  kernel<<<grid, k5::kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(bias),
      static_cast<bf16*>(out), S, dk, 1.0f / sqrtf(static_cast<float>(dk)),
      (uint32_t)layer * (uint32_t)N, drop);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32 body: exact FMA loops
// ---------------------------------------------------------------------------

constexpr int kFmaThreads = 256;

size_t fma_staged_bytes(int S, int dk) {
  return ((size_t)S * dk * 2 + (size_t)S * (dk + 1) +
          (size_t)(kFmaThreads / 32) * S) *
         sizeof(float);
}

// q, k and v in shared memory where they fit, else read in place.
bool fma_staged(int S, int dk) {
  return fma_staged_bytes(S, dk) <= cpc::kSmemLimit;
}

size_t fma_smem_bytes(int S, int dk) {
  return fma_staged(S, dk) ? fma_staged_bytes(S, dk)
                           : (size_t)(kFmaThreads / 32) * S * sizeof(float);
}

__global__ void __launch_bounds__(kFmaThreads) causal_attention_fwd_fma(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ bias,
    float* __restrict__ out, int S, int dk, float inv_sqrt, uint32_t w1_base,
    cpc::Dropout drop, bool staged) {
  extern __shared__ float smem[];
  const int n = blockIdx.x;
  const size_t base = (size_t)n * S * dk;
  const float* qs = q + base;     // (S, dk) rows, k with row stride ldk
  const float* ks = k + base;
  const float* vs = v + base;
  int ldk = dk;
  float* rows = smem;             // (n_warps, S) per-warp probability rows
  if (staged) {
    ldk = dk + 1;                 // lanes reading different keys: banks
    float* sq = smem;
    float* sk = sq + S * dk;
    float* sv = sk + S * ldk;
    rows = sv + S * dk;
    for (int idx = threadIdx.x; idx < S * dk; idx += blockDim.x) {
      const int i = idx / dk;
      const int d = idx - i * dk;
      sq[idx] = q[base + idx];
      sk[i * ldk + d] = k[base + idx];
      sv[idx] = v[base + idx];
    }
    qs = sq;
    ks = sk;
    vs = sv;
  }
  const uint32_t row_key =
      drop.active() ? cpc::dropout_row_key(drop.seed_word(),
                                           cpc::kSiteARAttention,
                                           w1_base + (uint32_t)n)
                    : 0u;
  __syncthreads();

  const float* bias_n = bias + (size_t)n * S * S;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  float* p = rows + warp * S;
  for (int i = warp; i < S; i += n_warps) {
    const float* qi = qs + i * dk;
    const float* bias_i = bias_n + (size_t)i * S;
    float mx = -INFINITY;
    for (int j = lane; j <= i; j += 32) {
      const float* kj = ks + j * ldk;
      float s = 0.0f;
      for (int d = 0; d < dk; ++d) s += qi[d] * kj[d];
      s = (s + bias_i[j]) * inv_sqrt;
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
    for (int j = lane; j <= i; j += 32)
      p[j] = p[j] * inv_sum * cpc::k5::drop_factor(drop, row_key, i, j, S);
    __syncwarp();
    for (int d = lane; d < dk; d += 32) {
      float o = 0.0f;
      for (int j = 0; j <= i; ++j) o += p[j] * vs[j * dk + d];
      out[base + (size_t)i * dk + d] = o;
    }
    __syncwarp();
  }
}

int launch_fma(const void* q, const void* k, const void* v, const void* bias,
               void* out, int N, int S, int dk, int layer, cpc::Dropout drop,
               cudaStream_t stream) {
  const size_t smem = fma_smem_bytes(S, dk);
  cudaError_t err = cpc::allow_smem(causal_attention_fwd_fma, smem);
  if (err != cudaSuccess) return (int)err;
  causal_attention_fwd_fma<<<N, kFmaThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(bias),
      static_cast<float*>(out), S, dk, 1.0f / sqrtf(static_cast<float>(dk)),
      (uint32_t)layer * (uint32_t)N, drop, fma_staged(S, dk));
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, out (N, S, dk) and bias (N, S, S) in `dtype`; dk <= 128, in
// bf16 a multiple of 8 with 16-byte aligned rows.
extern "C" int cpc_causal_attention_fwd(const void* q, const void* k,
                                        const void* v, const void* bias,
                                        void* out, int N, int S, int dk,
                                        int layer, const void* seed,
                                        unsigned int threshold,
                                        float keep_scale, int dtype,
                                        void* stream) {
  if (N <= 0 || S <= 0 || dk <= 0 || cpc::k5::padded_dk(dk) == 0 ||
      (dtype == cpc::kBFloat16 && dk % 8 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cpc::Dropout drop{static_cast<const int64_t*>(seed), threshold,
                          keep_scale};
  if (dtype == cpc::kBFloat16) {
    switch (cpc::k5::padded_dk(dk)) {
      case 32:
        return launch_mma<32>(q, k, v, bias, out, N, S, dk, layer, drop, s);
      case 64:
        return launch_mma<64>(q, k, v, bias, out, N, S, dk, layer, drop, s);
      default:
        return launch_mma<128>(q, k, v, bias, out, N, S, dk, layer, drop, s);
    }
  }
  if (dtype == cpc::kFloat32)
    return launch_fma(q, k, v, bias, out, N, S, dk, layer, drop, s);
  return (int)cudaErrorInvalidValue;
}
