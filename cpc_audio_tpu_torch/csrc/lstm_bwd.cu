// K1 backward: reverse scan of the whole-window LSTM.
//
// Replaces cpc_audio_tpu/ops/pallas/rnn.py `_lstm_bwd_kernel` (called
// through `_lstm_bwd`).  From the forward's saved gate activations
// i, f, g, o and cell states (float32), per batch row b and t = T-1 .. 0:
//   c_t  = f * c_{t-1} + i * g,          dh = dys[t] + dh_carry
//   do   = dh * tanh(c_t) * o (1 - o),   dc = dc_carry + dh * o (1 - tanh^2 c_t)
//   di   = dc * g * i (1 - i),  df = dc * c_{t-1} * f (1 - f),  dg = dc * i (1 - g^2)
//   dgates[b, t] = (di, df, dg, do);  dh_carry = dgates . W_hh;  dc_carry = dc * f
// and finally dh0 = dh_carry, dc0 = dc_carry, all in float32.  dW_hh is
// one matmul outside the kernel (ops/lstm.py), as rnn.py:223-226 does.
//
// Three bodies, picked from the shape before launching (`body`, mirrored
// by ops/lstm.py `bwd_body`): the cluster bodies below; the grid body at
// every other H past 256 (csrc/rnn_grid.cuh: W_hh split by unit over all
// of the card's SMs in one cooperative launch, each step's partial carry
// reduce-scattered through L2 with a grid barrier; `GridCell` is its
// elementwise part); the rows body at the other H up to 256.
//
// The cluster body (csrc/rnn_cluster.cuh), at H = 128 and 256 in both
// dtypes on C = 8 CTAs, and at H = 512 and 768 on C = 16: one
// cluster per 16 batch rows keeps W_hh on chip for the whole window,
// split by hidden unit (CTA c owns units [c H/C, (c+1) H/C) and their 4
// gate rows: 133 KB of bf16 W_hh at H = 512, 232 KB of the CTA's 227 KB
// in all), and each step's product dh = dgates . W_hh is a per-CTA
// partial product
// (mma.sync with a hi/lo split of dgates in bf16, FMA in float32)
// reduce-scattered over distributed shared memory, with one cluster
// barrier a step.  The elementwise part of a step needs only the CTA's own
// units.  At H = 768 in bf16, also on C = 16, a CTA's slice (192 gate
// rows by 768, 295 KB) does not fit: each warp holds 2 of the 12 k-steps
// of its columns in registers, 4 in shared memory and streams 6 (147 KB a
// CTA a step) from L2 through a two-stage ring of its own; the receive
// buffer has one parity, guarded by a second cluster barrier split around
// the product, and the residuals come through registers (`StreamLayout`;
// 219 KB a CTA).  In float32 at H = 512 and 768, W_hh (4-9 MB) exceeds
// even 16 CTAs' shared memory as it is: the same streamed body runs on
// W_hh's two bf16 planes, hi and lo (split once a call into scratch,
// `cpc::rnn::split_planes`), with 3 split products a k-step (dgates' hi
// and lo by W_hi, dgates' hi by W_lo: about 2^-16 of |dgates||W_hh| a
// term dropped; ops/lstm.py `lstm_bwd_split` writes that arithmetic): a
// warp's k-steps are the hi plane's 4J / 16, then the lo plane's, 4 and
// 18 of them streamed at H 512 and 768 (64 and 442 KB a CTA a step).
//
// The rows body, at the other H up to 256: as in the forward, one block
// per batch row keeps the carries in shared memory for the whole window.
// The serial product is the transpose of the forward's: dh[j] =
// sum_r dgates[r] W_hh[r, j] over the 4H gate rows of W_hh in torch's
// (4H, H) layout.  Threads own pairs of adjacent columns (one 4- or 8-byte
// load per row, a warp reads a contiguous run of a row) and form G groups
// that split the 4H rows; the G partial sums meet in shared memory.  Every
// step re-reads W_hh (512 KB in bf16 at H = 256) from L2, so a step costs
// one SM's L2 read bandwidth for it; B = 32 blocks use a quarter of the
// SMs.
//
// What bounds it on an H100: the T = 128 dependent steps.  The bytes it
// must move (0.012 ms at B 32, T 128, H 256) ignore that chain; cuDNN's
// LSTM backward, which also forms dx and dW, is its yardstick.  On 16
// CTAs the largest part of a step is the reduce-scatter's push over
// distributed shared memory: 3.6 of 4.8 us at H 512, 3.3 of 9.4 at H 768
// (port_perf/k1_step_parts.py removes it; NVIDIA H100 80GB HBM3, 700 W).
#include <type_traits>

#include "rnn_grid.cuh"

namespace {

constexpr int kThreads = 1024;
// ops/lstm.py MAX_H, the widest H checked on the card.
constexpr int kMaxH = 8192;

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// One unit's cell backward, shared by the bodies: from its gate
// activations i, f, g, o, the cell state c_{t-1}, dh (dys + carry) and
// the dc carry, the gate gradients out = (di, df, dg, do); returns the
// next dc carry.
__device__ __forceinline__ float cell_bwd(float ig, float fg, float gg,
                                          float og, float c_prev, float dhj,
                                          float dc, float out[4]) {
  const float cc = fg * c_prev + ig * gg;
  const float tc = tanhf(cc);
  const float d_o = dhj * tc * og * (1.0f - og);
  const float dcj = dc + dhj * og * (1.0f - tc * tc);
  out[0] = dcj * gg * ig * (1.0f - ig);
  out[1] = dcj * c_prev * fg * (1.0f - fg);
  out[2] = dcj * ig * (1.0f - gg * gg);
  out[3] = d_o;
  return dcj * fg;
}

// ---- the cluster body ------------------------------------------------------

// A pair's residuals of one step: gates (4 float2), c_{t-1} (float2), dys
// (two T); each field an array over the CTA's pairs.
template <typename T>
constexpr int kSlot = 5 * (int)sizeof(float2) + 2 * (int)sizeof(T);

template <typename T, int J, int C>
using ClusterLayout = cpc::rnn::Layout<T, 4, J, kSlot<T>, C>;

template <typename T, int J, int C>
__global__ void __launch_bounds__(ClusterLayout<T, J, C>::kThreads, 1)
    lstm_bwd_cluster_kernel(const float* __restrict__ gates,
                            const float* __restrict__ cs,
                            const T* __restrict__ c0,
                            const T* __restrict__ dys,
                            const T* __restrict__ w_hh,
                            const float* __restrict__ dhT,
                            const float* __restrict__ dcT,
                            float* __restrict__ dgates,
                            float* __restrict__ dh0, float* __restrict__ dc0,
                            int B, int n_steps) {
  namespace rnn = cpc::rnn;
  using L = ClusterLayout<T, J, C>;
  using T2 = typename rnn::Two<T>::type;
  constexpr int H = L::H, G4 = 4 * H, P = L::P;
  extern __shared__ __align__(16) unsigned char cluster_smem_buf[];
  unsigned char* smem = cluster_smem_buf;
  const int c = rnn::cluster_rank();
  const int b0 = blockIdx.y * rnn::kRows;
  const int tid = threadIdx.x;
  float2* dcs = reinterpret_cast<float2*>(smem + L::state);   // (P,) dc
  auto slot_of = [&](int t) {
    return smem + L::ring + (t & 1) * L::slot_bytes;
  };
  // slot fields: gate g of pair p at [g * P + p], c_{t-1} at [4 P + p]
  auto gates_of = [&](int t) { return reinterpret_cast<float2*>(slot_of(t)); };
  auto dys_of = [&](int t) {
    return reinterpret_cast<T2*>(slot_of(t) + 5 * P * sizeof(float2));
  };
  auto prefetch = [&](int t) {
    float2* g = gates_of(t);
    T2* dy = dys_of(t);
    for (int p = tid; p < P; p += L::kThreads) {
      const rnn::Pair<J> pr(p);
      const int b = b0 + pr.row;
      if (b >= B) continue;
      const int j = c * J + pr.unit;
      const size_t bt = (size_t)b * n_steps + t;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        rnn::cp_async<8>(g + q * P + p, gates + bt * G4 + q * H + j);
      if (t > 0) rnn::cp_async<8>(g + 4 * P + p, cs + (bt - 1) * H + j);
      rnn::copy_two<T>(dy + p, dys + bt * H + j);
    }
  };

  rnn::load_w<L>(reinterpret_cast<T*>(smem + L::w), w_hh, c);
  prefetch(n_steps - 1);
  cpc::mma::cp_async_commit();
  for (int p = tid; p < P; p += L::kThreads) {
    const rnn::Pair<J> pr(p);
    const int b = b0 + pr.row;
    dcs[p] = b < B ? *reinterpret_cast<const float2*>(
                         dcT + (size_t)b * H + c * J + pr.unit)
                   : make_float2(0.0f, 0.0f);
  }
  cpc::mma::cp_async_wait<0>();
  __syncthreads();
  rnn::cluster_sync();   // every CTA of the cluster runs before any push

  for (int t = n_steps - 1; t >= 0; --t) {
    if (t > 0) prefetch(t - 1);
    cpc::mma::cp_async_commit();
    cpc::mma::cp_async_wait<1>();   // this thread's copies of step t
    const float2* g = gates_of(t);
    const T2* dy = dys_of(t);
    for (int p = tid; p < P; p += L::kThreads) {
      const rnn::Pair<J> pr(p);
      const int b = b0 + pr.row;
      if (b >= B) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          rnn::put_a<L>(smem, pr.row, q, pr.unit, 0.0f, 0.0f);
        continue;
      }
      const int j = c * J + pr.unit;
      const size_t bt = (size_t)b * n_steps + t;
      const float2 carry =
          t == n_steps - 1
              ? *reinterpret_cast<const float2*>(dhT + (size_t)b * H + j)
              : rnn::gather<L>(smem, (t + 1) & 1, pr.row, pr.unit);
      const float2 ig2 = g[p], fg2 = g[P + p], gg2 = g[2 * P + p],
                   og2 = g[3 * P + p];
      const float2 cp2 = t > 0 ? g[4 * P + p]
                               : rnn::load_two(c0 + (size_t)b * H + j);
      const float2 dy2 = rnn::Two<T>::f32(dy[p]);
      float2 dc2 = dcs[p];
      float out[4][2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float o4[4];
        (e ? dc2.y : dc2.x) = cell_bwd(
            e ? ig2.y : ig2.x, e ? fg2.y : fg2.x, e ? gg2.y : gg2.x,
            e ? og2.y : og2.x, e ? cp2.y : cp2.x,
            (e ? dy2.y : dy2.x) + (e ? carry.y : carry.x),
            e ? dc2.y : dc2.x, o4);
#pragma unroll
        for (int q = 0; q < 4; ++q) out[q][e] = o4[q];
      }
      dcs[p] = dc2;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        *reinterpret_cast<float2*>(dgates + bt * G4 + q * H + j) =
            make_float2(out[q][0], out[q][1]);
        rnn::put_a<L>(smem, pr.row, q, pr.unit, out[q][0], out[q][1]);
      }
    }
    __syncthreads();
    rnn::product_push<L>(smem, c, t & 1);
    rnn::cluster_sync();
  }
  for (int p = tid; p < P; p += L::kThreads) {
    const rnn::Pair<J> pr(p);
    const int b = b0 + pr.row;
    if (b >= B) continue;
    const size_t o = (size_t)b * H + c * J + pr.unit;
    *reinterpret_cast<float2*>(dh0 + o) =
        rnn::gather<L>(smem, 0, pr.row, pr.unit);
    *reinterpret_cast<float2*>(dc0 + o) = dcs[p];
  }
}

// ---- the cluster body with a streamed remainder ----------------------------
// (bf16 at H 768, float32 at H 512 and 768)

using bf16 = __nv_bfloat16;

// One CTA of 16 at H = 16 J, whose slice of W_hh (4J gate rows by H, in
// PL bf16 planes) does not fit beside the rest: the A tile (dgates' hi
// and lo), ONE receive parity (16 slots of 16 x J float32), the SK
// resident k-steps of the slice (16 gate rows by H + 8 each) and every
// warp's ring (16 rows by J + 8 a stage).  Warp w serves columns [w J, w J
// + J) of all PL 4J / 16 k-steps, plane 0's then plane 1's: RK in
// registers, SK in shared memory, the rest streamed.  PL = 1: bf16 inputs
// and W_hh exact in bf16; PL = 2: float32 inputs and W_hh's hi and lo
// planes (`split_planes`), plane 0's k-steps multiplying dgates' hi and
// lo, plane 1's its hi.  The residuals of the next step are loaded into
// registers (a thread owns one pair of units for the whole window, and
// its dc), so the layout has no residual slots.
template <int J_, int RK, int SK, int D, int PL = 1>
struct StreamLayout {
  static constexpr bool kMma = true;
  using T = std::conditional_t<PL == 1, bf16, float>;
  static constexpr int kPlanes = PL;
  static constexpr int kCluster = 16, kThreads = 32 * kCluster;
  static constexpr int kJ = J_, H = kCluster * kJ, GJ = 4 * kJ;
  static constexpr int P = cpc::rnn::kRows * kJ / 2, NT = kJ / 8;
  static constexpr int lda = GJ + 8, ldw = H + 8, lds = kJ + 8;
  using S = cpc::rnn::Split<RK, SK, PL * GJ / 16 - RK - SK, D, 16 * lds>;
  static constexpr size_t a = 0;
  static constexpr size_t recv =
      a + cpc::rnn::round16((size_t)2 * cpc::rnn::kRows * lda * 2);
  static constexpr size_t res =
      recv + (size_t)kCluster * cpc::rnn::kRows * kJ * sizeof(float);
  static constexpr size_t ring = res + (size_t)SK * 16 * ldw * 2;
  static constexpr size_t bytes = ring + (size_t)kCluster * S::ring_elems * 2;
  static_assert(P <= kThreads && kJ % 16 == 0, "a pair a thread");
  static_assert(PL == 1 || PL == 2, "bf16 W_hh, or float32's two planes");
};

using Stream768 = StreamLayout<48, 2, 4, 2>;
// float32: 16 and 24 k-steps a warp, 4 and 18 of them streamed
using Stream512F = StreamLayout<32, 4, 8, 2, 2>;
using Stream768F = StreamLayout<48, 2, 4, 2, 2>;

// w: W_hh's PL bf16 planes ((4H, H) each, plane 1 4 H H elements past
// plane 0): w_hh itself in bf16, `split_planes`' output in float32.
template <typename L>
__global__ void __launch_bounds__(L::kThreads, 1)
    lstm_bwd_stream_kernel(const float* __restrict__ gates,
                           const float* __restrict__ cs,
                           const typename L::T* __restrict__ c0,
                           const typename L::T* __restrict__ dys,
                           const bf16* __restrict__ w,
                           const float* __restrict__ dhT,
                           const float* __restrict__ dcT,
                           float* __restrict__ dgates,
                           float* __restrict__ dh0, float* __restrict__ dc0,
                           int B, int n_steps) {
  namespace rnn = cpc::rnn;
  using S = typename L::S;
  using T2 = typename rnn::Two<typename L::T>::type;
  constexpr int J = L::kJ, H = L::H, G4 = 4 * H, NT = L::NT, GJ = L::GJ;
  extern __shared__ __align__(16) unsigned char stream_smem_buf[];
  unsigned char* smem = stream_smem_buf;
  const bf16* ahi = reinterpret_cast<const bf16*>(smem + L::a);
  const bf16* alo = ahi + rnn::kRows * L::lda;
  bf16* res = reinterpret_cast<bf16*>(smem + L::res);
  const int c = rnn::cluster_rank();
  const int b0 = blockIdx.y * rnn::kRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  bf16* ring = reinterpret_cast<bf16*>(smem + L::ring) +
               (size_t)warp * S::ring_elems;
  // W_hh's row of the slice's row k (of plane k / 4J: gate k % 4J / J,
  // unit k % J)
  auto w_row = [&](int k) {
    if constexpr (L::kPlanes == 1) {
      return w + (size_t)((k / J) * H + c * J + k % J) * H;
    } else {
      const int r = k % GJ;
      return w + (size_t)(k / GJ) * G4 * H +
             (size_t)((r / J) * H + c * J + r % J) * H;
    }
  };

  // the resident k-steps: slice rows [16 RK, 16 (RK + SK)), all columns
  constexpr int RP = H / 8;                   // 16-byte pieces a row
  for (int idx = tid; idx < S::SK * 16 * RP; idx += L::kThreads) {
    const int row = idx / RP, q = idx - row * RP;
    cpc::mma::cp_async16(res + row * L::ldw + q * 8,
                         w_row(S::RK * 16 + row) + q * 8, true);
  }
  cpc::mma::cp_async_commit();
  // the register k-steps' B fragments of the warp's NT n-tiles
  uint32_t breg[S::RK > 0 ? S::RK : 1][NT][2];
#pragma unroll
  for (int i = 0; i < S::RK; ++i)
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = warp * J + n * 8 + gq;
      const int k = i * 16 + 2 * tq;
      breg[i][n][0] = rnn::pack_two(w_row(k) + col, w_row(k + 1) + col);
      breg[i][n][1] = rnn::pack_two(w_row(k + 8) + col, w_row(k + 9) + col);
    }

  // the thread's pair of units (tid < P), its dc and its next residuals
  const bool owner = tid < L::P;
  const rnn::Pair<J> pr(owner ? tid : 0);
  const int b = b0 + pr.row;
  const bool valid = owner && b < B;
  const int j = c * J + pr.unit;
  float2 dc2 = valid ? *reinterpret_cast<const float2*>(dcT + (size_t)b * H +
                                                        j)
                     : make_float2(0.0f, 0.0f);
  float2 nxt[5];       // i, f, g, o, c_{t-1}
  T2 nxt_dy;
  auto load_res = [&](int t) {
    if (!valid) return;
    const size_t bt = (size_t)b * n_steps + t;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      nxt[q] = *reinterpret_cast<const float2*>(gates + bt * G4 + q * H + j);
    nxt[4] = t > 0 ? *reinterpret_cast<const float2*>(cs + (bt - 1) * H + j)
                   : rnn::load_two(c0 + (size_t)b * H + j);
    nxt_dy = *reinterpret_cast<const T2*>(dys + bt * H + j);
  };
  load_res(n_steps - 1);
  cpc::mma::cp_async_wait<0>();
  __syncthreads();
  // streamed k-step q of the warp: 16 slice rows by its J columns
  auto fill = [&](bf16* stage, int q) {
    const int k = (S::NR + q) * 16;
    rnn::copy_rows<16, J / 8, L::lds>(
        stage, [&](int r) { return w_row(k + r) + warp * J; });
  };
  S::prime(ring, fill);
  rnn::cluster_sync();   // every CTA of the cluster runs before any push

  float* slot = reinterpret_cast<float*>(smem + L::recv) +
                (size_t)c * rnn::kRows * J;
  for (int t = n_steps - 1; t >= 0; --t) {
    float2 cur[5];
#pragma unroll
    for (int q = 0; q < 5; ++q) cur[q] = nxt[q];
    const T2 cur_dy = nxt_dy;
    if (t > 0) load_res(t - 1);
    if (owner) {
      float out[4][2] = {};
      if (valid) {
        const float2 carry =
            t == n_steps - 1
                ? *reinterpret_cast<const float2*>(dhT + (size_t)b * H + j)
                : rnn::gather<L>(smem, 0, pr.row, pr.unit);
        const float2 dy2 = rnn::Two<typename L::T>::f32(cur_dy);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float o4[4];
          (e ? dc2.y : dc2.x) = cell_bwd(
              e ? cur[0].y : cur[0].x, e ? cur[1].y : cur[1].x,
              e ? cur[2].y : cur[2].x, e ? cur[3].y : cur[3].x,
              e ? cur[4].y : cur[4].x,
              (e ? dy2.y : dy2.x) + (e ? carry.y : carry.x),
              e ? dc2.y : dc2.x, o4);
#pragma unroll
          for (int q = 0; q < 4; ++q) out[q][e] = o4[q];
        }
        const size_t bt = (size_t)b * n_steps + t;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          *reinterpret_cast<float2*>(dgates + bt * G4 + q * H + j) =
              make_float2(out[q][0], out[q][1]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
        rnn::put_a<L>(smem, pr.row, q, pr.unit, out[q][0], out[q][1]);
    }
    __syncthreads();
    rnn::cluster_arrive();    // this CTA's reads of its receive buffer are done

    // P_c = A . W_slice over the warp's columns; the hi product and the
    // small ones (lo . W, and hi . W's lo plane) apart
    float acc_h[NT][4], acc_l[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_h[n][e] = acc_l[n][e] = 0.0f;
    // k-step at slice row k0 (plane k0 / 4J; a constant once unrolled)
    auto kstep = [&](int k0, auto&& b_of) {
      const bool lo_plane = k0 >= GJ;
      const int ka = lo_plane ? k0 - GJ : k0;
      uint32_t ah[4], al[4];
      cpc::mma::load_a(ah, ahi, L::lda, 0, ka);
      if (!lo_plane) cpc::mma::load_a(al, alo, L::lda, 0, ka);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bb[4];
        b_of(np, bb);
        if (lo_plane) {
          cpc::mma::mma_bf16(acc_l[2 * np], ah, bb[0], bb[1]);
          cpc::mma::mma_bf16(acc_l[2 * np + 1], ah, bb[2], bb[3]);
        } else {
          cpc::mma::mma_bf16(acc_h[2 * np], ah, bb[0], bb[1]);
          cpc::mma::mma_bf16(acc_l[2 * np], al, bb[0], bb[1]);
          cpc::mma::mma_bf16(acc_h[2 * np + 1], ah, bb[2], bb[3]);
          cpc::mma::mma_bf16(acc_l[2 * np + 1], al, bb[2], bb[3]);
        }
      }
    };
    S::product(
        ring,
        [&](int i) {
          if (i < S::RK) {
            const int ir = i < S::RK ? i : 0;
            kstep(i * 16, [&](int np, uint32_t (&bb)[4]) {
              bb[0] = breg[ir][2 * np][0];
              bb[1] = breg[ir][2 * np][1];
              bb[2] = breg[ir][2 * np + 1][0];
              bb[3] = breg[ir][2 * np + 1][1];
            });
          } else {
            kstep(i * 16, [&](int np, uint32_t (&bb)[4]) {
              cpc::mma::load_b_kmajor(bb, res, L::ldw, (i - S::RK) * 16,
                                      warp * J + np * 16);
            });
          }
        },
        [&](int q, const bf16* stage) {
          kstep((S::NR + q) * 16, [&](int np, uint32_t (&bb)[4]) {
            cpc::mma::load_b_kmajor(bb, stage, L::lds, 0, np * 16);
          });
        },
        fill);

    rnn::cluster_wait();      // every CTA is done reading its receive buffer
    // push as 16-byte stores: lanes tq and tq ^ 1 swap halves, so the
    // even one holds row gq, columns 2 tq .. 2 tq + 3, the odd one row
    // gq + 8, columns 2 tq - 2 .. 2 tq + 1
    const bool even = (tq & 1) == 0;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float x0 = acc_h[n][0] + acc_l[n][0];
      const float x1 = acc_h[n][1] + acc_l[n][1];
      const float x2 = acc_h[n][2] + acc_l[n][2];
      const float x3 = acc_h[n][3] + acc_l[n][3];
      const float s0 = __shfl_xor_sync(0xffffffffu, even ? x2 : x0, 1);
      const float s1 = __shfl_xor_sync(0xffffffffu, even ? x3 : x1, 1);
      const int u = n * 8 + 2 * (tq & 2);
      if (even)
        rnn::store_remote(slot + gq * J + u, warp,
                          make_float4(x0, x1, s0, s1));
      else
        rnn::store_remote(slot + (gq + 8) * J + u, warp,
                          make_float4(s0, s1, x2, x3));
    }
    rnn::cluster_sync();
  }
  if (valid) {
    const size_t o = (size_t)b * H + j;
    *reinterpret_cast<float2*>(dh0 + o) =
        rnn::gather<L>(smem, 0, pr.row, pr.unit);
    *reinterpret_cast<float2*>(dc0 + o) = dc2;
  }
}

// A CTA's shared memory in the cluster body at H: 8 CTAs at H = 128 and
// 256, 16 at H = 512 and 768 (with the streamed remainder at 768 in bf16
// and at both in float32); 0 at any other H.
template <typename T>
size_t cluster_smem(int H) {
  if constexpr (sizeof(T) < sizeof(float)) {
    if (H == 512) return ClusterLayout<T, 32, 16>::bytes;
    if (H == 768) return Stream768::bytes;
  } else {
    if (H == 512) return Stream512F::bytes;
    if (H == 768) return Stream768F::bytes;
  }
  return H == 128 ? ClusterLayout<T, 16, 8>::bytes
         : H == 256 ? ClusterLayout<T, 32, 8>::bytes
                    : 0;
}

// The cluster body takes H = 128, 256, 512 and 768: where its layout fits
// a CTA.
template <typename T>
bool cluster_body(int H) {
  const size_t smem = cluster_smem<T>(H);
  return smem > 0 && smem <= cpc::kSmemLimit;
}

// Bytes of scratch the backward needs: W_hh's two bf16 planes where the
// float32 cluster body streams them (H 512 and 768), else 0.
template <typename T>
size_t stream_scratch(int H) {
  return sizeof(T) == sizeof(float) && cluster_body<T>(H) && H >= 512
             ? (size_t)2 * 4 * H * H * sizeof(bf16)
             : 0;
}

template <typename L>
int launch_stream(const float* gates, const float* cs, const void* c0,
                  const void* dys, const void* w_hh, const float* dhT,
                  const float* dcT, float* dgates, float* dh0, float* dc0,
                  void* scratch, int B, int n_steps, cudaStream_t stream) {
  using T = typename L::T;
  const bf16* w = static_cast<const bf16*>(w_hh);
  if constexpr (L::kPlanes == 2) {
    bf16* planes = static_cast<bf16*>(scratch);
    const cudaError_t err =
        cpc::rnn::split_planes(static_cast<const float*>(w_hh), planes,
                               (size_t)4 * L::H * L::H, stream);
    if (err != cudaSuccess) return (int)err;
    w = planes;
  }
  return (int)cpc::rnn::launch<L>(
      lstm_bwd_stream_kernel<L>, B, stream, gates, cs,
      static_cast<const T*>(c0), static_cast<const T*>(dys), w, dhT, dcT,
      dgates, dh0, dc0, B, n_steps);
}

template <typename T, int J, int C>
int launch_cluster(const float* gates, const float* cs, const void* c0,
                   const void* dys, const void* w_hh, const float* dhT,
                   const float* dcT, float* dgates, float* dh0, float* dc0,
                   int B, int n_steps, cudaStream_t stream) {
  return (int)cpc::rnn::launch<ClusterLayout<T, J, C>>(
      lstm_bwd_cluster_kernel<T, J, C>, B, stream, gates, cs,
      static_cast<const T*>(c0), static_cast<const T*>(dys),
      static_cast<const T*>(w_hh), dhT, dcT, dgates, dh0, dc0, B, n_steps);
}

// ---- the rows body ---------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) lstm_bwd_kernel(
    const float* __restrict__ gates, const float* __restrict__ cs,
    const T* __restrict__ c0, const T* __restrict__ dys,
    const T* __restrict__ w_hh, const float* __restrict__ dhT,
    const float* __restrict__ dcT, float* __restrict__ dgates,
    float* __restrict__ dh0, float* __restrict__ dc0, int n_steps, int H) {
  extern __shared__ __align__(16) float smem[];
  const int G4 = 4 * H;
  const int n_pairs = H / 2;
  const int n_groups = blockDim.x / n_pairs;
  float* dg = smem;                 // (4H,) dgates of this step
  float* dh = dg + G4;              // (H,)  dh carry
  float* dc = dh + H;               // (H,)  dc carry
  float* part = dc + H;             // (n_groups, H) partial column sums
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int group = tid / n_pairs;

  for (int j = tid; j < H; j += blockDim.x) {
    dh[j] = dhT[(size_t)b * H + j];
    dc[j] = dcT[(size_t)b * H + j];
  }
  __syncthreads();

  for (int t = n_steps - 1; t >= 0; --t) {
    const size_t bt = (size_t)b * n_steps + t;
    const float* gt = gates + bt * G4;
    float* dgt = dgates + bt * G4;
    for (int j = tid; j < H; j += blockDim.x) {
      const float ig = gt[j], fg = gt[H + j], gg = gt[2 * H + j],
                  og = gt[3 * H + j];
      const float c_prev =
          t > 0 ? cs[(bt - 1) * H + j] : cpc::to_f32(c0[(size_t)b * H + j]);
      float o4[4];
      dc[j] = cell_bwd(ig, fg, gg, og, c_prev,
                       cpc::to_f32(dys[bt * H + j]) + dh[j], dc[j], o4);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        dg[q * H + j] = o4[q];
        dgt[q * H + j] = o4[q];
      }
    }
    __syncthreads();
    if (group < n_groups) {
      const int pair = tid % n_pairs;
      float a0 = 0.0f, a1 = 0.0f, b0 = 0.0f, b1 = 0.0f;
      const T* wcol = w_hh + 2 * pair;
      int r = group;
#pragma unroll 4
      for (; r + n_groups < G4; r += 2 * n_groups) {
        const float2 w = load2(wcol + (size_t)r * H);
        const float2 v = load2(wcol + (size_t)(r + n_groups) * H);
        a0 += dg[r] * w.x;
        a1 += dg[r] * w.y;
        b0 += dg[r + n_groups] * v.x;
        b1 += dg[r + n_groups] * v.y;
      }
      if (r < G4) {
        const float2 w = load2(wcol + (size_t)r * H);
        a0 += dg[r] * w.x;
        a1 += dg[r] * w.y;
      }
      part[group * H + 2 * pair] = a0 + b0;
      part[group * H + 2 * pair + 1] = a1 + b1;
    }
    __syncthreads();
    for (int j = tid; j < H; j += blockDim.x) {
      float s = 0.0f;
      for (int g = 0; g < n_groups; ++g) s += part[g * H + j];
      dh[j] = s;
    }
    __syncthreads();
  }
  for (int j = tid; j < H; j += blockDim.x) {
    dh0[(size_t)b * H + j] = dh[j];
    dc0[(size_t)b * H + j] = dc[j];
  }
}

template <typename T>
int launch(const float* gates, const float* cs, const void* c0,
           const void* dys, const void* w_hh, const float* dhT,
           const float* dcT, float* dgates, float* dh0, float* dc0, int B,
           int n_steps, int H, cudaStream_t stream) {
  const int n_groups = kThreads / (H / 2);
  const size_t smem = (size_t)(6 + n_groups) * H * sizeof(float);
  auto kernel = lstm_bwd_kernel<T>;
  cudaError_t err = cpc::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, kThreads, smem, stream>>>(
      gates, cs, static_cast<const T*>(c0), static_cast<const T*>(dys),
      static_cast<const T*>(w_hh), dhT, dcT, dgates, dh0, dc0, n_steps, H);
  return (int)cudaGetLastError();
}

// ---- the grid body (csrc/rnn_grid.cuh) --------------------------------------

// A thread's pair of units (k, k + 1) of batch row b: dc in registers.
template <typename T_>
struct GridCell {
  using T = T_;
  using T2 = typename cpc::rnn::Two<T>::type;
  static constexpr int G = 4;
  struct Params {
    const float* gates;
    const float* cs;
    const T* c0;
    const T* dys;
    const float* dhT;
    const float* dcT;
    float* dgates;
    float* dh0;
    float* dc0;
  };
  struct State {
    float2 dc;
  };
  struct Res {
    float2 g[4];     // i, f, g, o
    float2 cp;       // c_{t-1}
    T2 dy;
  };
  static Params offset(Params p, const cpc::grid::Shape& s, int b0) {
    const size_t r = (size_t)b0 * s.H, rt = r * s.T;
    p.gates += 4 * rt;
    p.cs += rt;
    p.c0 += r;
    p.dys += rt;
    p.dhT += r;
    p.dcT += r;
    p.dgates += 4 * rt;
    p.dh0 += r;
    p.dc0 += r;
    return p;
  }
  __device__ static State init(const Params& p, const cpc::grid::Shape& s,
                               int b, int k, bool valid) {
    return {valid ? *reinterpret_cast<const float2*>(p.dcT +
                                                     (size_t)b * s.H + k)
                  : make_float2(0.0f, 0.0f)};
  }
  __device__ static Res load_res(const Params& p, const cpc::grid::Shape& s,
                                 int b, int k, int t, bool valid) {
    Res r;
    if (!valid) return r;
    const int H = s.H;
    const size_t bt = (size_t)b * s.T + t;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      r.g[q] = *reinterpret_cast<const float2*>(p.gates + bt * 4 * H +
                                                q * H + k);
    r.cp = t > 0 ? *reinterpret_cast<const float2*>(p.cs + (bt - 1) * H + k)
                 : cpc::rnn::load_two(p.c0 + (size_t)b * H + k);
    r.dy = *reinterpret_cast<const T2*>(p.dys + bt * H + k);
    return r;
  }
  __device__ static void step(const Params& p, const cpc::grid::Shape& s,
                              State& st, const Res& r, float2 carry,
                              bool first, int b, int k, int t,
                              float (&dg)[4][2]) {
    const int H = s.H;
    const float2 dy = cpc::rnn::Two<T>::f32(r.dy);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float o4[4];
      float& dc = e ? st.dc.y : st.dc.x;
      dc = cell_bwd(e ? r.g[0].y : r.g[0].x, e ? r.g[1].y : r.g[1].x,
                    e ? r.g[2].y : r.g[2].x, e ? r.g[3].y : r.g[3].x,
                    e ? r.cp.y : r.cp.x,
                    (e ? dy.y : dy.x) + (e ? carry.y : carry.x), dc, o4);
#pragma unroll
      for (int q = 0; q < 4; ++q) dg[q][e] = o4[q];
    }
    const size_t bt = (size_t)b * s.T + t;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      *reinterpret_cast<float2*>(p.dgates + bt * 4 * H + q * H + k) =
          make_float2(dg[q][0], dg[q][1]);
  }
  __device__ static void finish(const Params& p, const cpc::grid::Shape& s,
                                const State& st, float2 carry, int b,
                                int k) {
    const size_t o = (size_t)b * s.H + k;
    *reinterpret_cast<float2*>(p.dh0 + o) = carry;
    *reinterpret_cast<float2*>(p.dc0 + o) = st.dc;
  }
};

// The body at H for T: 1 the cluster body, 2 the grid body (every H past
// 256 with no cluster body), 0 the rows body.
template <typename T>
int body(int H) {
  return cluster_body<T>(H) ? 1 : H >= cpc::grid::kMinH ? 2 : 0;
}

template <typename T>
int launch_any(const float* gates, const float* cs, const void* c0,
               const void* dys, const void* w_hh, const float* dhT,
               const float* dcT, float* dgates, float* dh0, float* dc0,
               void* scratch, unsigned* bar, int B, int n_steps, int H,
               cudaStream_t stream) {
  if (body<T>(H) == 2) {
    if (bar == nullptr) return (int)cudaErrorInvalidValue;
    typename GridCell<T>::Params p{
        gates, cs, static_cast<const T*>(c0), static_cast<const T*>(dys),
        dhT, dcT, dgates, dh0, dc0};
    return cpc::grid::run_bwd<GridCell<T>>(p, w_hh, scratch, bar, B, n_steps,
                                           H, stream);
  }
  if (!cluster_body<T>(H))
    return launch<T>(gates, cs, c0, dys, w_hh, dhT, dcT, dgates, dh0, dc0, B,
                     n_steps, H, stream);
  if (H == 128)
    return launch_cluster<T, 16, 8>(gates, cs, c0, dys, w_hh, dhT, dcT,
                                    dgates, dh0, dc0, B, n_steps, stream);
  if (H == 256)
    return launch_cluster<T, 32, 8>(gates, cs, c0, dys, w_hh, dhT, dcT,
                                    dgates, dh0, dc0, B, n_steps, stream);
  if constexpr (sizeof(T) < sizeof(float)) {   // H 512 and 768 in bf16
    if (H == 768)
      return launch_stream<Stream768>(gates, cs, c0, dys, w_hh, dhT, dcT,
                                      dgates, dh0, dc0, scratch, B, n_steps,
                                      stream);
    return launch_cluster<T, 32, 16>(gates, cs, c0, dys, w_hh, dhT, dcT,
                                     dgates, dh0, dc0, B, n_steps, stream);
  } else {                                     // H 512 and 768 in float32
    if (H == 768)
      return launch_stream<Stream768F>(gates, cs, c0, dys, w_hh, dhT, dcT,
                                       dgates, dh0, dc0, scratch, B, n_steps,
                                       stream);
    return launch_stream<Stream512F>(gates, cs, c0, dys, w_hh, dhT, dcT,
                                     dgates, dh0, dc0, scratch, B, n_steps,
                                     stream);
  }
}

}  // namespace

// The body cpc_lstm_bwd runs at hidden width H in `dtype`: 0 rows, 1
// cluster, 2 grid (ops/lstm.py `bwd_body`).
extern "C" int cpc_lstm_bwd_body(int H, int dtype) {
  return dtype == cpc::kBFloat16 ? body<__nv_bfloat16>(H) : body<float>(H);
}

// The cluster body's shared memory a CTA at H in `dtype` (0: rows body
// at every H it has no layout for).
extern "C" size_t cpc_lstm_bwd_smem(int H, int dtype) {
  return dtype == cpc::kBFloat16 ? cluster_smem<__nv_bfloat16>(H)
                                 : cluster_smem<float>(H);
}

// Bytes of scratch cpc_lstm_bwd needs at (B, H, dtype): W_hh's bf16
// planes for the float32 cluster body at H 512 and 768; the grid body's
// receive blocks (and its planes in float32); else 0.
extern "C" size_t cpc_lstm_bwd_scratch(int B, int H, int dtype) {
  const bool f32 = dtype == cpc::kFloat32;
  if ((f32 ? body<float>(H) : body<__nv_bfloat16>(H)) == 2)
    return cpc::grid::scratch_bytes(true, B, H, 4, f32 ? 2 : 1);
  return f32 ? stream_scratch<float>(H) : 0;
}

// gates (B, T, 4H), cs (B, T, H), dhT, dcT (B, H) and the outputs dgates
// (B, T, 4H), dh0, dc0 (B, H) are float32; c0 (B, H), dys (B, T, H) and
// w_hh (4H, H) are in `dtype`; scratch: cpc_lstm_bwd_scratch bytes
// (16-byte aligned; null where 0); barrier: the grid body's barrier word
// (csrc/rnn_grid.cuh; null for the other bodies).
extern "C" int cpc_lstm_bwd(const void* gates, const void* cs, const void* c0,
                            const void* dys, const void* w_hh,
                            const void* dhT, const void* dcT, void* dgates,
                            void* dh0, void* dc0, void* scratch,
                            void* barrier, int B, int n_steps, int H,
                            int dtype, void* stream) {
  if (H <= 0 || H % 8 != 0 || H > kMaxH)
    return (int)cudaErrorInvalidValue;
  unsigned* bar = static_cast<unsigned*>(barrier);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gates);
  const float* c = static_cast<const float*>(cs);
  const float* dh = static_cast<const float*>(dhT);
  const float* dc = static_cast<const float*>(dcT);
  float* dg = static_cast<float*>(dgates);
  float* h0 = static_cast<float*>(dh0);
  float* c0o = static_cast<float*>(dc0);
  if (dtype == cpc::kBFloat16)
    return launch_any<__nv_bfloat16>(g, c, c0, dys, w_hh, dh, dc, dg, h0,
                                     c0o, scratch, bar, B, n_steps, H, s);
  if (dtype == cpc::kFloat32)
    return launch_any<float>(g, c, c0, dys, w_hh, dh, dc, dg, h0, c0o,
                             scratch, bar, B, n_steps, H, s);
  return (int)cudaErrorInvalidValue;
}
