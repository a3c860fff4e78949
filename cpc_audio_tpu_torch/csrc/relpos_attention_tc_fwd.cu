// K2: causal attention with Shaw relative positions, forward, on the
// tensor cores (the body at every S <= 4096 and dk <= 4096: past dk 512 on
// a thread-block cluster of ceil(dk / 512) CTAs).
//
// Replaces cpc_audio_tpu/ops/pallas/head_attention.py `_fwd_kernel`
// (called through `fused_relpos_attention`).  Per (k, batch row b, head h):
//   s[i, j] = (q_i . k_j + q_i . krel[k][:, j - i + S - 1]) / sqrt(dk), j <= i
//   o_i     = round(softmax_j(s[i, :]) * dropout[i, :]) . v
// in the natural (K, B*S, D = nheads*dk) layout of the K-batched
// projections; round() is the rounding of the probabilities to the input
// dtype before their product with v, as the Pallas kernel casts them.
// Softmax statistics are float32.  Dropout (dropout.cuh, keyed on (k, b,
// h, i, j)) drops the probabilities after the normalising sum.
//
// Design (relpos_attention_tc.cuh): K5's forward (causal_attention_fwd.cu)
// with the bias formed in the kernel.  One block of 4 warps per (query
// tile, head), tiles of 64 rows (32 past 128 bf16 planes' values a row).
// The q tile is staged once; for each key tile up to the diagonal, k, v
// and the krel window are staged with cp.async into a double buffer (one
// where that lets more blocks share an SM: `pick_bufs`).  Each warp forms
// its row group's window product QP (16 rows x T + 16 window columns) on
// mma.sync, stages it in shared memory, then the scores q . k^T, to which
// each element adds its band value; the mask, the max and sum, the
// dropout factor and the rounding of the probabilities stay in registers,
// and p . v runs on mma.sync with the probability accumulators as its A
// operand.  In bf16 a first walk over the key tiles finds each row's max
// and sum, so that the second rounds the normalised p r, as the JAX kernel
// rounds it (K5's one walk rounds exp(s - running max) r and divides by the
// sum after p . v: one bf16 ulp off, which took an output past chip_smoke's
// bf16 tolerance at S 244, where terms of p . v cancel).  Float32 keeps
// that one walk: its planes carry p r exactly.  In float32, q, k, v and krel are split once a call into three
// bf16 planes (six split products a product, as K5's forward:
// ops/head_attention.py `relpos_attention_split` writes the arithmetic);
// where the float32 window of DKP 256 does not fit beside the tiles, it is
// staged 64 rows of dk at a time.  At DKP 512 (16-row tiles, all four
// warps on the rows; relpos_attention_tc.cuh) each warp forms QP's band
// and q . k^T over its quarter of dk, summed w 0 + 1 + 2 + 3 through 8 KB
// of shared memory; in float32 the window's three planes (120 KB) do not
// fit beside the q, k, v tiles (146 KB), so each quarter's rows are staged
// 64 at a time, two chunks a key tile.  Past dk 512 the cluster body
// (relpos_attention_tc.cuh): CTA c of the tile's cluster runs DKP 512's
// kernel on dk columns [512 c, 512 c + 512), the partial band and scores
// of its four warps summed in the CTA and then over the cluster, CTA 0 + 1
// + ..., through distributed shared memory, one cluster barrier a key
// tile and one more whose wait the next tile's products hide; in float32
// the window's first chunk is staged with the key tile, so that a tile
// waits on two loads, not three.
//
// What bounds it on an H100: at K 12, B 32, 8 heads, S 116, dk 32 the call
// reads q, k, v (68 MB in bf16) and writes o (23 MB): 27 us at 3.35 TB/s;
// its 0.8 GFLOP of causal products (6 dk a pair) take 1 us at the bf16
// peak.  The tiles pad S 116 to 128 and the window product adds 1.25 score
// tiles a key tile; 1.5 blocks of (query tile, head) an SM's worth of
// loads are in flight at a time.
#include "relpos_attention_tc.cuh"

namespace {

using cpc::k2::bf16;
namespace k2 = cpc::k2;
namespace k5 = cpc::k5;

// bf16 planes a float32 operand of the forward: three, as K5's
constexpr int kF32Planes = 3;

template <typename T, int DKP>
using FwdGeom =
    k5::Geom<T, DKP, sizeof(T) == sizeof(float) ? kF32Planes : 1>;

// q, `bufs` (k, v) buffers, the krel window (whole: `bufs` buffers; in
// chunks of kc < DKP rows: one), the QP band; at kSplitK the partials; in
// the cluster body (CL) the scores' partials beside the band's and the
// exchange block
template <typename T, int DKP, bool CL = false>
constexpr size_t fwd_bytes(int bufs, int kc) {
  using G = FwdGeom<T, DKP>;
  using W = k2::Win<G>;
  return (1 + 2 * bufs) * G::kTileElems * sizeof(bf16) +
         (kc == DKP ? bufs : 1) * W::kr_elems(kc) * sizeof(bf16) +
         W::kQpBytes + W::kRedBytes +
         (CL ? (k2::kExchangeFloats<G, false> +
                k5::kPartialFloats<G::kNT>) * sizeof(float)
             : 0);
}

template <typename T, int DKP, bool CL = false>
struct Fwd {
  using G = FwdGeom<T, DKP>;
  using W = k2::Win<G>;
  // window rows a chunk: all, else 64 (at kSplitK 64 of each quarter)
  static constexpr int kKC = fwd_bytes<T, DKP, CL>(1, DKP) <= cpc::kSmemLimit
                                 ? DKP
                                 : G::kSplitK ? 4 * 64 : 64;
  static constexpr int kBufs = k2::pick_bufs(fwd_bytes<T, DKP, CL>(1, kKC),
                                             fwd_bytes<T, DKP, CL>(2, kKC));
  static constexpr size_t kSmem = fwd_bytes<T, DKP, CL>(kBufs, kKC);
  static_assert(kSmem <= cpc::kSmemLimit, "K2 forward shared memory");
  static_assert(!CL || G::kSplitK, "the cluster body runs DKP 512's tiles");
};

template <typename T, int DKP, bool CL = false>
__global__ void __launch_bounds__(k5::kThreads) relpos_tc_fwd(
    k2::Heads H, const bf16* __restrict__ krp, int sk, T* __restrict__ out,
    float inv_sqrt, cpc::Dropout drop) {
  using C = Fwd<T, DKP, CL>;
  using G = typename C::G;
  using W = typename C::W;
  constexpr int TE = G::kTileElems;
  constexpr int NB = C::kBufs;
  constexpr int KC = C::kKC;
  constexpr bool kWhole = KC == DKP;
  constexpr int KRE = W::kr_elems(KC);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + TE;               // NB buffers
  bf16* Vs = Ks + NB * TE;          // NB buffers
  bf16* Kr = Vs + NB * TE;          // NB windows (whole) or one chunk
  float* QPs = reinterpret_cast<float*>(Kr + (kWhole ? NB : 1) * KRE);

  const k2::Cta cta = k2::this_cta<CL>();
  const int n = CL ? blockIdx.x / cta.n : blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;   // every head's longest first
  const int q0 = qt * G::kTile;
  const int S = H.S;
  const int nb = n / H.nheads;
  const int warp = threadIdx.x >> 5;
  const int rw = warp % G::kRowWarps;          // the warp's 16 rows
  const int c0 = warp / G::kRowWarps * G::kDV;  // its output columns
  // the cluster body: the CTA's columns from col0, the warp's sl.live
  // from sl.gw (none past dk: no products), krel's planes of dkr rows
  const k2::Slab sl = k2::slab<CL, G>(cta, H.dk, warp);
  const int col0 = sl.col0, dkr = k2::plane_rows<CL, DKP>(H.dk);
  const bool live = sl.live > 0;
  bool armed = false;   // CL: a cluster arrive outstanding
  const int r0 = q0 + rw * 16;
  const int c_lo = W::c_lo(rw);
  const int kk = nb / H.n_batch;
  const uint32_t row_key = cpc::attention_row_key(
      drop, kk, H.n_batch, nb % H.n_batch, H.nheads, n % H.nheads);
  float* Red = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(QPs) + W::kQpBytes);   // kSplitK
  float* X = Red + W::kRedBytes / sizeof(float) +
             k5::kPartialFloats<G::kNT>;                      // CL
  constexpr int KQ = KC / 4;   // kSplitK: a quarter's rows a chunk
  // key tile kt (and its v where with_v) into buffer b
  auto stage_tile = [&](int kt, int b, bool with_v) {
    k2::stage_head<G, DKP, CL>(Ks + b * TE, H, 1, n, kt * G::kTile, col0);
    if (with_v)
      k2::stage_head<G, DKP, CL>(Vs + b * TE, H, 2, n, kt * G::kTile, col0);
    if constexpr (kWhole && G::kSplitK)
      k2::stage_quarters<G, DKP, KQ, CL>(
          Kr + b * KRE, krp, kk, sk, 0, sk - (qt - kt + 1) * G::kTile, dkr,
          col0, H.dk);
    else if constexpr (kWhole)
      k2::stage_window<G, DKP, DKP>(Kr + b * KRE, krp, kk, sk, 0,
                                    sk - (qt - kt + 1) * G::kTile);
    else if constexpr (CL)   // the window's first chunk with the tile
      k2::stage_quarters<G, DKP, KQ, CL>(
          Kr, krp, kk, sk, 0, sk - (qt - kt + 1) * G::kTile, dkr, col0,
          H.dk);
    cpc::mma::cp_async_commit();
  };
  // the warp's scores of key tile kt in buffer buf, biased, scaled and
  // masked: the row group's window product staged as its band first
  auto scores = [&](float (&s)[G::kNT][4], int kt, int buf, int n_hi) {
    float qp[W::kBandNT][4];
    k2::zero_band<G>(qp);
    if constexpr (G::kSplitK) {   // the warp's quarter c0 of dk, summed
      if constexpr (kWhole) {
        if (live)
          k2::window_product<G, KQ>(
              qp, Qs, 0, Kr + buf * KRE + warp * W::kr_elems(KQ), c0, c_lo);
      } else {
        for (int c = 0; c < G::kDV; c += KQ) {
          if (CL && col0 + c >= H.dk) break;   // no warp's rows live
          if (!CL || c > 0) {   // CL: chunk 0 came with the key tile
            __syncthreads();   // the chunk before is read
            k2::stage_quarters<G, DKP, KQ, CL>(
                Kr, krp, kk, sk, c, sk - (qt - kt + 1) * G::kTile, dkr,
                col0, H.dk);
            cpc::mma::cp_async_commit();
            cpc::mma::cp_async_wait<0>();
            __syncthreads();
          }
          if (live)
            k2::window_product<G, KQ>(qp, Qs, 0,
                                      Kr + warp * W::kr_elems(KQ), c0 + c,
                                      c_lo);
        }
      }
      if constexpr (CL) {   // the CTA's sums, then the cluster's
        if (live)
          k5::rows_dot_rows<G, G::kDV>(s, Qs + c0, 0, Ks + buf * TE + c0, 0,
                                       n_hi);
        else
          k2::zero_tile<G::kNT>(s);
        k2::cta_band_scores<G>(qp, s, Red, X, armed);
        k2::cluster_sums<G, false>(QPs, W::kLdq, s, s, X, cta.n, armed);
      } else {
        k2::sum_band<G>(QPs, qp, Red, W::kLdq);
        k5::rows_dot_rows<G, G::kDV>(s, Qs + c0, 0, Ks + buf * TE + c0, 0,
                                     n_hi);
        k5::store_partial<G::kNT>(Red, s);
        __syncthreads();
        // Red is stored again past the iteration's last __syncthreads
        k5::load_sum<G::kNT>(s, Red);
      }
    } else {
      if constexpr (kWhole) {
        k2::window_product<G, KC>(qp, Qs, rw * 16, Kr + buf * KRE, 0, c_lo);
      } else {
        for (int d0 = 0; d0 < DKP; d0 += KC) {
          __syncthreads();   // the chunk before is read
          k2::stage_window<G, DKP, KC>(Kr, krp, kk, sk, d0,
                                       sk - (qt - kt + 1) * G::kTile);
          cpc::mma::cp_async_commit();
          cpc::mma::cp_async_wait<0>();
          __syncthreads();
          k2::window_product<G, KC>(qp, Qs, rw * 16, Kr, d0, c_lo);
        }
      }
      if (c0 == 0) k2::store_band<G>(QPs, qp, rw, W::kLdq);
      if constexpr (G::kColWarps > 1)
        __syncthreads();   // the pair's other warp reads the band
      else
        __syncwarp();
      k5::rows_dot_rows<G, DKP>(s, Qs, rw * 16, Ks + buf * TE, 0, n_hi);
    }
    k2::bias_scale_mask<G>(s, QPs, W::kLdq, rw, q0, kt * G::kTile,
                           inv_sqrt);
  };
  // waits for key tile kt, with tile kt + 1 put in flight where there
  // are two buffers
  auto next_tile = [&](int kt, int buf, bool with_v) {
    if (NB == 2 && kt < qt) {
      stage_tile(kt + 1, buf ^ 1, with_v);
      cpc::mma::cp_async_wait<1>();
    } else {
      cpc::mma::cp_async_wait<0>();
    }
    __syncthreads();
  };

  // bf16: the rows' max and sum first, so that the probabilities are
  // rounded normalised, as the JAX kernel rounds p r before . v; float32
  // keeps the running max and sum, its planes carrying p r exactly
  constexpr bool kStatsWalk = !G::kF32;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  k2::stage_head<G, DKP, CL>(Qs, H, 0, n, q0, col0);
  stage_tile(0, 0, !kStatsWalk);
  if constexpr (kStatsWalk) {
    for (int kt = 0; kt <= qt; ++kt) {
      const int buf = NB == 2 ? kt & 1 : 0;
      next_tile(kt, buf, false);
      float s[G::kNT][4];
      scores(s, kt, buf, kt == qt ? 2 * rw + 2 : G::kNT);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int nt = 0; nt < G::kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      float ls[2] = {0.0f, 0.0f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = k5::quad_max(mx[h]);   // finite: key 0 <= every row
        l[h] *= expf(m[h] - mx[h]);
        m[h] = mx[h];
      }
#pragma unroll
      for (int nt = 0; nt < G::kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) ls[e >> 1] += expf(s[nt][e] - m[e >> 1]);
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] += k5::quad_sum(ls[h]);
      __syncthreads();   // buffer `buf` and the band are reused next
      if (NB == 1 && kt < qt) stage_tile(kt + 1, 0, false);
    }
    stage_tile(0, 0, true);
  }
  const float inv_l[2] = {1.0f / l[0], 1.0f / l[1]};

  float o[G::kDV / 8][4];
#pragma unroll
  for (int nt = 0; nt < G::kDV / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.0f;
  for (int kt = 0; kt <= qt; ++kt) {
    const int buf = NB == 2 ? kt & 1 : 0;
    const int n_hi = kt == qt ? 2 * rw + 2 : G::kNT;
    const uint32_t keep =
        k5::keep_bits<G>(drop, row_key, r0, kt * G::kTile, 0, n_hi, S);
    next_tile(kt, buf, true);
    float s[G::kNT][4];
    scores(s, kt, buf, n_hi);
    if constexpr (kStatsWalk) {
#pragma unroll
      for (int nt = 0; nt < G::kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[nt][e] = expf(s[nt][e] - m[e >> 1]) * inv_l[e >> 1] *
                     k5::kept_factor(drop, keep, nt, e);
    } else {
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int nt = 0; nt < G::kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
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
      for (int h = 0; h < 2; ++h)
        l[h] = l[h] * rescale[h] + k5::quad_sum(ls[h]);
#pragma unroll
      for (int nt = 0; nt < G::kDV / 8; ++nt) {
        o[nt][0] *= rescale[0];
        o[nt][1] *= rescale[0];
        o[nt][2] *= rescale[1];
        o[nt][3] *= rescale[1];
      }
    }
    if (live)
      k5::acc_times_rows<G, false>(o, s, Vs + buf * TE + c0, 0, n_hi / 2);
    __syncthreads();   // buffer `buf` and the band are reused next
    if (NB == 1 && kt < qt) stage_tile(kt + 1, 0, true);
  }
  const float one[2] = {1.0f, 1.0f};
  const float fin[2] = {1.0f / l[0], 1.0f / l[1]};
  const int D = H.nheads * H.dk;
  if constexpr (CL)   // the warp's columns from sl.gw
    k5::store_rows<G>(out + H.natural(n, D) + sl.gw, o, r0, 0, S, sl.live,
                      kStatsWalk ? one : fin, D);
  else
    k5::store_rows<G>(out + H.natural(n, D), o, r0, c0, S, H.dk,
                      kStatsWalk ? one : fin, D);
  if (armed) k2::cluster_wait();   // the cluster has read the block
}

template <typename T, int DKP>
int launch(const k2::Heads& H, const bf16* krp, int sk, void* out, int N,
           cpc::Dropout drop, cudaStream_t stream) {
  using C = Fwd<T, DKP>;
  auto kernel = relpos_tc_fwd<T, DKP>;
  cudaError_t err = cpc::allow_smem(kernel, C::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(N, (H.S + C::G::kTile - 1) / C::G::kTile);
  kernel<<<grid, k5::kThreads, C::kSmem, stream>>>(
      H, krp, sk, static_cast<T*>(out),
      1.0f / sqrtf(static_cast<float>(H.dk)), drop);
  return (int)cudaGetLastError();
}

// The cluster body: DKP 512's kernel on clusters of ceil(dk / 512) CTAs.
template <typename T>
int launch_cluster(const k2::Heads& H, const bf16* krp, int sk, void* out,
                   int N, cpc::Dropout drop, cudaStream_t stream) {
  using C = Fwd<T, 512, true>;
  const int nc = k2::cluster_ctas(H.dk);
  const dim3 grid(N * nc, (H.S + C::G::kTile - 1) / C::G::kTile);
  return (int)k2::launch_cluster(
      relpos_tc_fwd<T, 512, true>, grid, nc, C::kSmem, stream, H, krp, sk,
      static_cast<T*>(out), 1.0f / sqrtf(static_cast<float>(H.dk)), drop);
}

template <typename T>
int launch_any(const k2::Heads& H, const bf16* krp, int sk, void* out, int N,
               cpc::Dropout drop, cudaStream_t s) {
  if (H.dk > k2::kSlab) return launch_cluster<T>(H, krp, sk, out, N, drop, s);
  switch (k5::padded_dk(H.dk)) {
    case 32:
      return launch<T, 32>(H, krp, sk, out, N, drop, s);
    case 64:
      return launch<T, 64>(H, krp, sk, out, N, drop, s);
    case 128:
      return launch<T, 128>(H, krp, sk, out, N, drop, s);
    case 256:
      return launch<T, 256>(H, krp, sk, out, N, drop, s);
    default:
      return launch<T, 512>(H, krp, sk, out, N, drop, s);
  }
}

k2::Prep prep_of(int K, int n_batch, int S, int nheads, int dk, int dtype) {
  return k2::Prep(K, K * n_batch * nheads, S, dk, dtype, 3, kF32Planes);
}

}  // namespace

// The body the forward runs at (S, dk), in both dtypes: 1, the tensor-core
// tiles, at S <= 4096 and dk <= 512; 2, the cluster body, at dk 513-4096;
// 0 past those (k2::takes), where the wrapper refuses.
extern "C" int cpc_relpos_attention_fwd_body(int S, int dk, int dtype) {
  (void)dtype;
  return !k2::takes(S, dk) ? 0 : dk <= k2::kSlab ? 1 : 2;
}

// Bytes of scratch the tensor-core forward needs: krel's padded planes
// and, in float32 (and in bf16 where dk % 8 != 0), the planes of q, k and
// v by head.
extern "C" size_t cpc_relpos_attention_fwd_tc_scratch(int K, int n_batch,
                                                      int S, int nheads,
                                                      int dk, int dtype) {
  return prep_of(K, n_batch, S, nheads, dk, dtype).bytes();
}

// q, k, v, out (K, n_batch*S, nheads*dk) and krel (K, dk, S) in `dtype`;
// scratch of cpc_relpos_attention_fwd_tc_scratch bytes, 256-byte aligned.
extern "C" int cpc_relpos_attention_fwd_tc(
    const void* q, const void* k, const void* v, const void* krel, void* out,
    void* scratch, int K, int n_batch, int S, int nheads, int dk,
    const void* seed, unsigned int threshold, float keep_scale, int dtype,
    void* stream) {
  const int N = K * n_batch * nheads;
  if (K <= 0 || n_batch <= 0 || nheads <= 0 || scratch == nullptr ||
      cpc_relpos_attention_fwd_body(S, dk, dtype) == 0 ||
      (dtype != cpc::kFloat32 && dtype != cpc::kBFloat16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cpc::Dropout drop{static_cast<const int64_t*>(seed), threshold,
                          keep_scale};
  const k2::Prep pr = prep_of(K, n_batch, S, nheads, dk, dtype);
  const void* ops[3] = {q, k, v};
  k2::Heads H{};
  const bf16* krp = nullptr;
  cudaError_t err =
      dtype == cpc::kFloat32
          ? k2::prepare<float>(pr, krel, ops, 3, scratch, K, n_batch, S,
                               nheads, dk, H, krp, s)
          : k2::prepare<bf16>(pr, krel, ops, 3, scratch, K, n_batch, S,
                              nheads, dk, H, krp, s);
  if (err != cudaSuccess) return (int)err;
  return dtype == cpc::kFloat32
             ? launch_any<float>(H, krp, pr.sk, out, N, drop, s)
             : launch_any<bf16>(H, krp, pr.sk, out, N, drop, s);
}
