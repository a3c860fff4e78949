// K5: causal attention with a dense bias, forward (the transformer AR).
//
// Replaces cpc_audio_tpu/ops/pallas/attention.py `_fwd_kernel` (called
// through `fused_causal_attention`).  Per row n of N = B * nheads:
//   s[i, j] = (q_i . k_j + bias[n, i, j]) / sqrt(dk),  j <= i
//   o_i     = round(softmax_j(s[i, :]) * dropout[i, :]) . v
// with q, k, v, o (N, S, dk) and bias (N, S, S), all in one dtype; round()
// is the rounding of the probabilities to that dtype, as the Pallas kernel
// casts them before its product with v (none in float32).  Softmax
// statistics are float32.  In training the probabilities are dropped after
// the normalising sum (dropout.cuh at the AR attention site, keyed on
// (layer, n, i * S + j)).  The Pallas kernel pads S to the TPU's tiles;
// this one takes S as it is.  Shapes: dk <= 512 (a multiple of 8 in
// bf16), any S (its scratch is O(N S dk); the wrapper keeps i * S + j in
// 32 bits; every offset into the (N, S, S) bias is 64-bit).  The gate,
// ops/causal_attention.py `supported`, takes S up to 4096.
//
// One tensor-core body for both dtypes (causal_attention.cuh): one block
// of 4 warps per (query tile, n).  The q tile is staged once; k, v and the
// causal chunk of the bias for each key tile up to the diagonal are
// staged with cp.async into a double buffer (tile t + 1 in flight while t
// is used; a single buffer where two do not fit, float32 at DKP 256 and
// 512), so no block reads bias above the diagonal.  q.k^T and p.v run
// on mma.sync m16n8k16 (bf16 in, float32 sums); the bias, the mask, the
// running (online) max and sum, the dropout factor and the rounding happen
// in registers, and the probability accumulators are the A operand of p.v
// directly.  Registers stay flat in S: one key tile of scores at a time,
// the output rescaled as the running max moves.  The one departure from
// the two-pass Pallas softmax: a probability is formed as exp(s - running
// max) * r and divided by the row sum after p.v, so in bf16 its rounding
// can differ from round(p * r) by one ulp, well inside the output's own
// bf16 rounding.  In float32 q, k and v are first split into three bf16
// planes each (`split_operands`), and q.k^T and p.v (p split into three
// planes in registers) take six split products each: about 2^-24 of each
// term, well under 1 % of chip_smoke's float32 tolerance, where three
// products from two planes reached 17-19 % of it and missed the exact
// float32 check of tests/test_torch_cuda.py (ops/causal_attention.py
// `causal_attention_split`).  Past DKP 128 in bf16 (32 in float32) the
// tiles are 32 rows and each pair of warps shares 16 query rows, one half
// of the output columns each; at DKP 512 the tiles are 16 rows, shared by
// all four warps, a quarter of the output columns each (one key buffer
// in float32, whose three planes of q, k and v take 49 KB a tile), and
// each warp forms q.k^T over its quarter of dk only: the four partial
// score tiles are summed w 0 + 1 + 2 + 3 through 4 KB of shared memory
// (causal_attention.cuh `kSplitK`), so each score is formed once.
//
// What bounds it on an H100: at N = 256, S = 128, dk = 32 the call moves
// 16.8 MB in bf16 (the bias's causal half is half of it) for 0.27 GFLOP of
// causal products: memory, 5 us at 3.35 TB/s; twice the bytes in float32,
// plus the planes' 8.4 MB written and read once more.  The 512 blocks of
// ~43 KB (bf16; 114 KB in float32) keep loads in flight across blocks;
// each block waits on its own tile loads.
#include "causal_attention.cuh"

namespace {

using cpc::k5::bf16;
namespace k5 = cpc::k5;

// bf16 planes a float32 operand of the forward: three, which hold it
// exactly (two in the backward)
constexpr int kF32Planes = 3;

template <typename T, int DKP>
using FwdGeom =
    k5::Geom<T, DKP, sizeof(T) == sizeof(float) ? kF32Planes : 1>;

// q, `bufs` (k, v) buffers (bf16 planes), `bufs` bias buffers (T); at
// kSplitK the warps' partial scores
template <typename T, int DKP>
constexpr size_t smem_bytes(int bufs) {
  using G = FwdGeom<T, DKP>;
  return (size_t)(1 + 2 * bufs) * G::kTileElems * sizeof(bf16) +
         (size_t)bufs * G::kBiasElems * sizeof(T) +
         (G::kSplitK ? k5::kPartialFloats<G::kNT> * sizeof(float) : 0);
}

// Key-tile buffers: two (the next tile in flight), one where two do not
// fit (float32 at DKP 256: 264 KB; at 512: 251 KB)
template <typename T, int DKP>
constexpr int kBufs = smem_bytes<T, DKP>(2) <= cpc::kSmemLimit ? 2 : 1;

// q, k, v: the bf16 operands as they are (rows `lds` = dk apart) or the
// float32 operands' planes (lds = DKP, `plane` elements apart).
template <typename T, int DKP>
__global__ void __launch_bounds__(k5::kThreads) causal_attention_fwd_mma(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const T* __restrict__ bias,
    T* __restrict__ out, int S, int dk, int lds, size_t plane,
    float inv_sqrt, uint32_t w1_base, cpc::Dropout drop) {
  using G = FwdGeom<T, DKP>;
  constexpr int TE = G::kTileElems;
  constexpr int NB = kBufs<T, DKP>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + TE;              // NB buffers
  bf16* Vs = Ks + NB * TE;         // NB buffers
  T* Bs = reinterpret_cast<T*>(Vs + NB * TE);  // NB buffers of (kTile, kLdb)
  float* Red = reinterpret_cast<float*>(Bs + NB * G::kBiasElems);  // kSplitK

  const int n = blockIdx.y;
  const int qt = gridDim.x - 1 - blockIdx.x;   // longest rows first
  const int q0 = qt * G::kTile;
  const size_t base = (size_t)n * S * lds;
  const T* bias_n = bias + (size_t)n * S * S;
  const int warp = threadIdx.x >> 5;
  const int rw = warp % G::kRowWarps;          // the warp's 16 rows
  const int c0 = warp / G::kRowWarps * G::kDV;  // its output columns
  const int r0 = q0 + rw * 16;                 // the warp's first row
  const uint32_t row_key =
      drop.active() ? cpc::dropout_row_key(drop.seed_word(),
                                           cpc::kSiteARAttention,
                                           w1_base + (uint32_t)n)
                    : 0u;
  auto stage_tile = [&](int kt, int b) {   // key tile kt into buffer b
    const int k0 = kt * G::kTile;
    k5::stage_rows<G, DKP>(Ks + b * TE, k + base, plane, k0, S, lds, lds);
    k5::stage_rows<G, DKP>(Vs + b * TE, v + base, plane, k0, S, lds, lds);
    k5::stage_bias<G>(Bs + b * G::kBiasElems, bias_n, q0, k0, S);
    cpc::mma::cp_async_commit();
  };

  k5::stage_rows<G, DKP>(Qs, q + base, plane, q0, S, lds, lds);
  stage_tile(0, 0);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float o[G::kDV / 8][4];
#pragma unroll
  for (int nt = 0; nt < G::kDV / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.0f;

  for (int kt = 0; kt <= qt; ++kt) {
    const int buf = NB == 2 ? kt & 1 : 0;
    // n8 tiles of keys that can be <= one of the warp's rows; the dropout
    // bits need no data, so they are drawn while the tile's copy is in
    // flight
    const int n_hi = kt == qt ? 2 * rw + 2 : G::kNT;
    const uint32_t keep = k5::keep_bits<G>(drop, row_key, r0,
                                           kt * G::kTile, 0, n_hi, S);
    if (NB == 2 && kt < qt) {   // next key tile into the other buffer
      stage_tile(kt + 1, buf ^ 1);
      cpc::mma::cp_async_wait<1>();
    } else {
      cpc::mma::cp_async_wait<0>();
    }
    __syncthreads();

    float s[G::kNT][4];
    if constexpr (G::kSplitK) {   // the warp's quarter of dk, then the sum
      k5::rows_dot_rows<G, G::kDV>(s, Qs + c0, rw * 16, Ks + buf * TE + c0,
                                   0, n_hi);
      k5::store_partial<G::kNT>(Red, s);
      __syncthreads();
      k5::load_sum<G::kNT>(s, Red);   // Red is stored again past the
    } else {                          // iteration's last __syncthreads
      k5::rows_dot_rows<G, DKP>(s, Qs, rw * 16, Ks + buf * TE, 0, n_hi);
    }
    const T* Bb = Bs + buf * G::kBiasElems;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < G::kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ri = rw * 16 + k5::row_of(e), cj = k5::col_of(nt, e);
        const int i = q0 + ri, j = kt * G::kTile + cj;
        const float x =
            j <= i ? (s[nt][e] + cpc::to_f32(Bb[ri * G::kLdb + cj])) *
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
    for (int nt = 0; nt < G::kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] - m[e >> 1]);
        ls[e >> 1] += p;
        s[nt][e] = p * k5::kept_factor(drop, keep, nt, e);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * rescale[h] + k5::quad_sum(ls[h]);
#pragma unroll
    for (int nt = 0; nt < G::kDV / 8; ++nt) {
      o[nt][0] *= rescale[0];
      o[nt][1] *= rescale[0];
      o[nt][2] *= rescale[1];
      o[nt][3] *= rescale[1];
    }
    k5::acc_times_rows<G, false>(o, s, Vs + buf * TE + c0, 0, n_hi / 2);
    __syncthreads();   // buffer `buf` is restaged by iteration kt + 1
    if (NB == 1 && kt < qt) stage_tile(kt + 1, 0);
  }
  const float inv_l[2] = {1.0f / l[0], 1.0f / l[1]};
  k5::store_rows<G>(out + (size_t)n * S * dk, o, r0, c0, S, dk, inv_l);
}

template <typename T, int DKP>
int launch(const bf16* q, const bf16* k, const bf16* v, const void* bias,
           void* out, int N, int S, int dk, int lds, size_t plane, int layer,
           cpc::Dropout drop, cudaStream_t stream) {
  using G = FwdGeom<T, DKP>;
  const size_t smem = smem_bytes<T, DKP>(kBufs<T, DKP>);
  auto kernel = causal_attention_fwd_mma<T, DKP>;
  cudaError_t err = cpc::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + G::kTile - 1) / G::kTile, N);
  kernel<<<grid, k5::kThreads, smem, stream>>>(
      q, k, v, static_cast<const T*>(bias), static_cast<T*>(out), S, dk, lds,
      plane, 1.0f / sqrtf(static_cast<float>(dk)),
      (uint32_t)layer * (uint32_t)N, drop);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_any(const bf16* q, const bf16* k, const bf16* v, const void* bias,
               void* out, int N, int S, int dk, int lds, size_t plane,
               int layer, cpc::Dropout drop, cudaStream_t s) {
  switch (k5::padded_dk(dk)) {
    case 32:
      return launch<T, 32>(q, k, v, bias, out, N, S, dk, lds, plane, layer,
                           drop, s);
    case 64:
      return launch<T, 64>(q, k, v, bias, out, N, S, dk, lds, plane, layer,
                           drop, s);
    case 128:
      return launch<T, 128>(q, k, v, bias, out, N, S, dk, lds, plane, layer,
                            drop, s);
    case 256:
      return launch<T, 256>(q, k, v, bias, out, N, S, dk, lds, plane, layer,
                            drop, s);
    default:
      return launch<T, 512>(q, k, v, bias, out, N, S, dk, lds, plane, layer,
                            drop, s);
  }
}

}  // namespace

// Bytes of scratch the forward needs: the float32 operands' three bf16
// planes (q, k, v), none in bf16.
extern "C" size_t cpc_causal_attention_fwd_scratch(int N, int S, int dk,
                                                   int dtype) {
  return dtype == cpc::kFloat32 ? k5::planes_bytes(3, kF32Planes, N, S, dk)
                                : 0;
}

// q, k, v, out (N, S, dk) and bias (N, S, S) in `dtype`; dk <= 512, in
// bf16 a multiple of 8 with 16-byte aligned rows; scratch of
// cpc_causal_attention_fwd_scratch bytes, 16-byte aligned (null where 0).
extern "C" int cpc_causal_attention_fwd(const void* q, const void* k,
                                        const void* v, const void* bias,
                                        void* out, void* scratch, int N,
                                        int S, int dk, int layer,
                                        const void* seed,
                                        unsigned int threshold,
                                        float keep_scale, int dtype,
                                        void* stream) {
  if (N <= 0 || N > 65535 || S <= 0 || dk <= 0 || k5::padded_dk(dk) == 0 ||
      (dtype == cpc::kBFloat16 && dk % 8 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cpc::Dropout drop{static_cast<const int64_t*>(seed), threshold,
                          keep_scale};
  if (dtype == cpc::kBFloat16)
    return launch_any<bf16>(static_cast<const bf16*>(q),
                            static_cast<const bf16*>(k),
                            static_cast<const bf16*>(v), bias, out, N, S, dk,
                            dk, 0, layer, drop, s);
  if (dtype != cpc::kFloat32 || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  bf16* planes = static_cast<bf16*>(scratch);
  const k5::Operands ops{{static_cast<const float*>(q),
                          static_cast<const float*>(k),
                          static_cast<const float*>(v), nullptr}};
  const cudaError_t err = k5::split(ops, 3, kF32Planes, planes, N * S, dk, s);
  if (err != cudaSuccess) return (int)err;
  const int dkp = k5::padded_dk(dk);
  const size_t plane = (size_t)N * S * dkp;    // elements, plane to plane
  constexpr int P = kF32Planes;
  return launch_any<float>(planes, planes + P * plane, planes + 2 * P * plane,
                           bias, out, N, S, dk, dkp, plane, layer, drop, s);
}
