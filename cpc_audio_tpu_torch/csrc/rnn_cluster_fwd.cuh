// The thread-block-cluster forward of the K1 and K4 recurrences
// (csrc/lstm_fwd.cu, csrc/gru_fwd.cu): one kernel template for the LSTM
// (G = 4 gates) and the GRU (G = 3) on clusters of C = 8 CTAs (portable)
// or 16.  The layouts at H 128 and 256, K1's and K4's, are below
// (`with_resident_layout`), K1's at 512 and 768 in csrc/lstm_fwd.cu,
// mirrored by ops/lstm.py `FWD_CLUSTER` and ops/gru.py `FWD_CLUSTER`.
//
// One cluster serves 16 batch rows (one m16 tile; B = 32 takes two
// clusters, B 1 one with 15 rows of padding), and CTA c owns the J = H / C
// units [c J, c J + J) and their G gate rows of W_hh.  A step computes the
// CTA's gates (16 x G J) = h_{t-1} (16 x H) . W_slice^T on
// mma.sync.m16n8k16, h fed as the bf16 two-term split hi + lo of its
// float32 value (W_hh is exact in bf16), the slice the B operand read
// n-major.  Warp (u, p) takes units [8u, 8u + 8) of all G gates, so that
// one thread ends up holding every gate of its own units, over part p of
// the H-deep product; the KS parts meet in shared memory in a fixed
// order.  The warps of parts 0 and 1 then run the cell (`Cell`, the grid
// body's, csrc/rnn_grid.cuh: float32 state in registers for the whole
// window) for one row each and write h's hi and lo into the CTA's block in
// global memory, and the step's outputs once the block is on its way; the
// next step's x_proj is loaded into registers while a step computes.  The
// exchange is an all-gather through L2: one thread hands the block to all
// C CTAs' A tiles with one multicast bulk copy, and each CTA's mbarrier
// counts the C blocks in before its next product.  (A 2 KB block a step to
// 16 CTAs takes 2.0 us as stores over distributed shared memory plus a
// cluster barrier, 0.55 as the multicast: port_perf/allgather.py, NVIDIA
// H100 80GB HBM3, 700 W.)  No atomics, sums in a fixed order, reruns
// bit-identical.
//
// Where the slice fits (H 128 at C 8, H 256 at C 16, H 512 at C 16 in
// bf16) it is
// resident for the whole window, in registers as mma fragments and in
// shared memory, and the A tile has two parities, so a step needs no
// cluster barrier.  Where it does not (H 768, and H 512 in float32) each
// warp streams its last k-steps from L2 every step (`Split`) and the A
// tile has one parity, with a cluster barrier, split around the cell, that
// keeps a step's copies out until every CTA has read its tile.  In float32
// W_hh is not exact in bf16: the body runs on its two bf16 planes, hi and
// lo (split once a call into the scratch, `split_planes`), with 3 split
// products a k-step (h's hi and lo by W_hi, h's hi by W_lo: about 2^-16 of
// |h||W_hh| a term dropped; ops/lstm.py `lstm_scan_split`, ops/gru.py
// `gru_scan_split` write that arithmetic), a warp's k-steps the hi
// plane's then the lo plane's.
//
// What bounds it on an H100: the T steps are serial, and W_hh is read
// once a window (but for the streamed remainder), so a step costs the
// partial product (2 x 16 x G J x H multiply-adds a CTA, hi and lo), the
// cell on a third to a half of the warps, and the multicast's round trip
// through L2.
#pragma once

#include <type_traits>

#include "rnn_grid.cuh"

namespace cpc {
namespace rnn {

// h's bf16 hi and lo rows of one CTA's units, as a block of the A tile:
// [hi, lo][16 rows][J], 16-byte chunks swizzled so that ldmatrix's eight
// rows of a chunk column hit distinct banks (rows of 32, 64 or 96 bytes).
template <int J>
struct Block {
  static constexpr int kElems = 2 * kRows * J;
  static constexpr uint32_t kBytes = kElems * 2;
  static_assert(J == 16 || J == 32 || J == 48,
                "chunk swizzle for 2, 4 or 6 chunks a row");
  // element offset of (row, col) within a tile
  __device__ __forceinline__ static int at(int row, int col) {
    const int sw = J == 32 ? (row >> 1) & 3 : (row >> 2) & 1;
    return row * J + (((col >> 3) ^ sw) << 3) + (col & 7);
  }
};

// One CTA's shared memory: NP parities of the A tile (C blocks, one a
// CTA), the resident part of the slice (warp w's R = 8 G gate rows at rows
// [R w, R w + R), SK k-steps + 8 padding a row), the warps' rings (R rows
// by 16 + 8 a stage), the partial gates the warps leave one another and
// an mbarrier a parity.  PL: W_hh's bf16 planes, 1 for bf16 inputs
// (exact), 2 for float32 ones (hi and lo, `split_planes`): a warp's NKW
// k-steps of each, plane 0's first, the first RK of them in registers,
// the next SK in shared memory and the rest streamed.
template <int J_, int KS_, int RK, int SK, int D, int NP_, int PL = 1,
          int C_ = 16, int G_ = 4>
struct FwdLayout {
  static constexpr int J = J_, KS = KS_, NP = NP_, kCluster = C_, G = G_;
  static constexpr int H = C_ * J, R = 8 * G_;
  static constexpr int NU = J / 8, kWarps = NU * KS, kThreads = 32 * kWarps;
  static constexpr int NKW = H / 16 / KS;           // k-steps a warp a plane
  static constexpr int ldr = SK * 16 + 8, lds = 16 + 8;
  // floats a lane leaves a unit group: parts 0 and 1 own rows gq and
  // gq + 8 and leave the other row's 2 G gates, the rest all 4 G
  static constexpr int PER = 4 * G_ * (KS - 1);
  static constexpr uint16_t kMask = (uint16_t)((1u << C_) - 1);
  using T = std::conditional_t<PL == 1, __nv_bfloat16, float>;
  static constexpr int kPlanes = PL;
  using S = Split<RK, SK, PL * NKW - RK - SK, D, R * lds>;
  using Blk = Block<J>;
  static constexpr size_t a = 0;
  static constexpr size_t res = a + (size_t)NP * C_ * Blk::kBytes;
  static constexpr size_t ring = res + (size_t)kWarps * R * ldr * 2;
  static constexpr size_t part = ring + (size_t)kWarps * S::ring_elems * 2;
  static constexpr size_t bar = part + (size_t)NU * PER * 32 * sizeof(float);
  static constexpr size_t bytes = bar + NP * sizeof(uint64_t);
  // bytes of global scratch at batch B: in float32 W_hh's two bf16 planes
  // (first), then two parities of every CTA's block
  static size_t scratch(int B) {
    const size_t clusters = (B + kRows - 1) / kRows;
    return (PL == 2 ? (size_t)2 * G_ * H * H * 2 : 0) +
           2 * clusters * C_ * Blk::kBytes;
  }
  static_assert(J % 16 == 0 && (H / 16) % KS == 0 && PL * NKW >= RK + SK &&
                    KS >= 2 && (NP == 1 || NP == 2) &&
                    (PL == 1 || PL == 2) && (C_ == 8 || C_ == 16) &&
                    (G_ == 3 || G_ == 4),
                "");
};

// K1's (G 4) and K4's (G 3) layouts at H 128 on 8 CTAs and at 256 on 16
// (J 16 both; ops/lstm.py `FWD_CLUSTER[128 / 256]`, which ops/gru.py
// takes): a warp's k-steps of the slice resident (bf16: all in registers;
// float32, two planes: 4 in registers, at 256 the other 4 in shared
// memory), two parities of the A tile, no cluster barrier
template <int G>
using Fwd128 = FwdLayout<16, 4, 2, 0, 1, 2, 1, 8, G>;
template <int G>
using Fwd256 = FwdLayout<16, 4, 4, 0, 1, 2, 1, 16, G>;
template <int G>
using Fwd128F = FwdLayout<16, 4, 4, 0, 1, 2, 2, 8, G>;
template <int G>
using Fwd256F = FwdLayout<16, 4, 4, 4, 1, 2, 2, 16, G>;

// f(L{}) with the layout of G gates above at H in `dtype`; false at any
// other H.
template <int G, typename F>
bool with_resident_layout(int H, int dtype, F f) {
  if (dtype == ::cpc::kBFloat16) {
    if (H == 128) { f(Fwd128<G>{}); return true; }
    if (H == 256) { f(Fwd256<G>{}); return true; }
  } else if (dtype == ::cpc::kFloat32) {
    if (H == 128) { f(Fwd128F<G>{}); return true; }
    if (H == 256) { f(Fwd256F<G>{}); return true; }
  }
  return false;
}

// w: W_hh's PL bf16 planes ((G H, H) each, plane 1 G H H elements past
// plane 0): w_hh itself in bf16, `split_planes`' output in float32.
// Cell: the grid body's (csrc/rnn_grid.cuh `fwd_kernel`), whose `cell`
// and `store` halves of `step` run apart here.
template <typename L, typename Cell>
__global__ void __launch_bounds__(L::kThreads, 1)
    fwd_cluster_kernel(typename Cell::Params p, int B, int n_steps,
                       const mma::bf16* __restrict__ w,
                       mma::bf16* __restrict__ scratch) {
  using bf16 = mma::bf16;
  using Sp = typename L::S;
  using Blk = typename L::Blk;
  using X = typename Cell::X;
  static_assert(std::is_same<typename Cell::T, typename L::T>::value &&
                    Cell::G == L::G,
                "");
  constexpr int J = L::J, H = L::H, G = L::G, GH = G * H, NU = L::NU;
  constexpr int KS = L::KS, C = L::kCluster, NKW = L::NKW, R = L::R;
  extern __shared__ __align__(16) unsigned char cluster_fwd_smem[];
  unsigned char* smem = cluster_fwd_smem;
  bf16* atile = reinterpret_cast<bf16*>(smem + L::a);   // [NP][CTA]
  bf16* res = reinterpret_cast<bf16*>(smem + L::res);
  float* part = reinterpret_cast<float*>(smem + L::part);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bar);
  // the cell's shape, H a constant (its index arithmetic folds)
  grid::Shape s{};
  s.B = B;
  s.T = n_steps;
  s.H = H;
  s.G = G;
  s.PL = L::kPlanes;
  const int c = cluster_rank();
  const int b0 = blockIdx.y * kRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ug = warp % NU, kp = warp / NU;
  const int gq = lane >> 2, tq = lane & 3;
  const int k_warp = kp * NKW * 16;           // the warp's first k
  bf16* ring = reinterpret_cast<bf16*>(smem + L::ring) +
               (size_t)warp * Sp::ring_elems;
  // this CTA's block of parity q in global memory
  auto own_block = [&](int q) {
    return scratch + (((size_t)q * gridDim.y + blockIdx.y) * C + c) *
                         Blk::kElems;
  };
  // row r (0..7) of the warp's n-tile of gate g, in W_hh's plane pl
  auto w_row = [&](int g, int r, int pl) {
    return w + (size_t)pl * GH * H + (size_t)(g * H + c * J + ug * 8 + r) * H;
  };

  if (tid == 0) {
    for (int q = 0; q < L::NP; ++q) mbar_init(full + q, 1);
    fence_mbar_init();
  }
  // the resident k-steps of every warp's R rows
  constexpr int RP = L::ldr / 8 - 1;          // 16-byte pieces a row
  for (int idx = tid; idx < L::kWarps * R * RP; idx += L::kThreads) {
    const int row = idx / RP, q = idx - row * RP;
    const int w_ = row / R, g = (row % R) >> 3, r = row & 7;
    const int i = Sp::RK + q / 2;             // the piece's k-step
    const bf16* src = w + (size_t)(i / NKW) * GH * H +
                      (size_t)(g * H + c * J + (w_ % NU) * 8 + r) * H +
                      (w_ / NU) * NKW * 16 + (i % NKW) * 16 + (q & 1) * 8;
    mma::cp_async16(res + row * L::ldr + q * 8, src, true);
  }
  mma::cp_async_commit();
  // the register k-steps' B fragments of the warp's G n-tiles
  uint32_t breg[Sp::RK > 0 ? Sp::RK : 1][G][2];
#pragma unroll
  for (int i = 0; i < Sp::RK; ++i)
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const bf16* src =
          w_row(g, gq, i / NKW) + k_warp + (i % NKW) * 16 + 2 * tq;
      breg[i][g][0] = *reinterpret_cast<const uint32_t*>(src);
      breg[i][g][1] = *reinterpret_cast<const uint32_t*>(src + 8);
    }
  // parity 0 of the A tile <- h0 (rows past B zero)
  for (int idx = tid; idx < kRows * H / 2; idx += L::kThreads) {
    const int row = idx / (H / 2), col = 2 * (idx - row * (H / 2));
    const int b = b0 + row;
    const float2 v = b < B ? load_two(p.h0 + (size_t)b * H + col)
                           : make_float2(0.0f, 0.0f);
    uint32_t hi, lo;
    mma::split_pair(hi, lo, v.x, v.y);
    bf16* blk = atile + (col / J) * Blk::kElems + Blk::at(row, col % J);
    *reinterpret_cast<uint32_t*>(blk) = hi;
    *reinterpret_cast<uint32_t*>(blk + kRows * J) = lo;
  }
  fence_proxy_shared();   // before the copies that overwrite it
  // parts 0 and 1 own row gq + 8 kp of the lane's cells, units u0, u0 + 1
  const bool owner = kp < 2;
  const int u0 = ug * 8 + 2 * tq;
  const int j0 = c * J + u0;
  const int row = gq + 8 * (kp & 1);
  const int brow = b0 + row;
  const bool valid = owner && brow < B;
  typename Cell::State st = Cell::init(p, s, brow, j0, valid);
  X xnext = Cell::load_x(p, s, brow, j0, 0, valid);
  mma::cp_async_wait<0>();
  __syncthreads();
  // streamed k-step q of the warp: its R rows by 16 k
  auto fill = [&](bf16* stage, int q) {
    if constexpr (Sp::QK > 0) {
      const int i = Sp::NR + q;
      const int k = k_warp + (i % NKW) * 16;
      copy_rows<R, 2, L::lds>(stage, [&](int r) {
        return w_row(r >> 3, r & 7, i / NKW) + k;
      });
    }
  };
  Sp::prime(ring, fill);
  cluster_sync();   // every CTA's mbarriers are set before any copy

  for (int t = 0; t < n_steps; ++t) {
    // A tile parity cur holds h_{t-1} (C blocks copied at step t - 1),
    // h_t goes to parity nxt; the global blocks alternate
    const int cur = L::NP == 2 ? t & 1 : 0, nxt = L::NP == 2 ? cur ^ 1 : 0;
    const int sq = (t + 1) & 1;
    const bool more = t + 1 < n_steps;
    if (t > 0)
      mbar_wait(full + cur, (L::NP == 2 ? (t - 1) >> 1 : t - 1) & 1);
    if (tid == 0 && more) mbar_expect(full + nxt, C * Blk::kBytes);
    const X x = xnext;
    // the next step's x_proj, in registers until its cell: where the slice
    // is resident (steps of 1.5 us) loaded here, two products ahead; where
    // part of it streams (H 768, and 512 in float32: registers at their
    // cap, steps of 5 us and more) after this step's cell, one product
    // ahead, so that one X, not two, lives across the product (else ptxas
    // spills this step's X and reloads it in the cell, on the exchange's
    // path)
    constexpr bool kLateX = Sp::QK > 0;
    if (!kLateX && more) xnext = Cell::load_x(p, s, brow, j0, t + 1, valid);

    // the partial product over the warp's part of k; the hi product and
    // the small ones (lo . W, and hi . W's lo plane) apart (two dependence
    // chains)
    const bf16* a_cur = atile + cur * C * Blk::kElems;
    float acc_h[G][4], acc_l[G][4];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_h[g][e] = acc_l[g][e] = 0.0f;
    // k-step i of the warp (plane i / NKW; a constant once unrolled)
    auto kstep = [&](int i, const uint32_t (&b)[G][2]) {
      const bool lo_plane = i >= NKW;
      const int k = k_warp + (i % NKW) * 16;
      // rows lane & 15, chunk of k + 8 (lane >> 4), of the block holding k
      const int r = lane & 15;
      const bf16* hi = a_cur + (k / J) * Blk::kElems +
                       Blk::at(r, k % J + ((lane >> 4) << 3));
      uint32_t ah[4], al[4];
      mma::ldmatrix_x4(ah, hi);
      if (!lo_plane) mma::ldmatrix_x4(al, hi + kRows * J);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (lo_plane) {
          mma::mma_bf16(acc_l[g], ah, b[g][0], b[g][1]);
        } else {
          mma::mma_bf16(acc_h[g], ah, b[g][0], b[g][1]);
          mma::mma_bf16(acc_l[g], al, b[g][0], b[g][1]);
        }
      }
    };
    // B fragments of the G gates from a tile of the warp's R rows
    auto from_tile = [&](const bf16* tile, int ld, int k0,
                         uint32_t (&b)[G][2]) {
#pragma unroll
      for (int h = 0; h < G / 2; ++h) {
        uint32_t v[4];
        mma::load_b_nmajor(v, tile, ld, 16 * h, k0);
        b[2 * h][0] = v[0];
        b[2 * h][1] = v[1];
        b[2 * h + 1][0] = v[2];
        b[2 * h + 1][1] = v[3];
      }
      if constexpr (G % 2 == 1)
        mma::load_b_nmajor_x2(b[G - 1], tile, ld, 8 * (G - 1), k0);
    };
    Sp::product(
        ring,
        [&](int i) {
          if (i < Sp::RK) {
            kstep(i, breg[i < Sp::RK ? i : 0]);
          } else {
            uint32_t b[G][2];
            from_tile(res + warp * R * L::ldr, L::ldr, (i - Sp::RK) * 16, b);
            kstep(i, b);
          }
        },
        [&](int q, const bf16* stage) {
          uint32_t b[G][2];
          from_tile(stage, L::lds, 0, b);
          kstep(Sp::NR + q, b);
        },
        fill);
    // one parity: the copies of this step wait until every CTA is done
    // reading its A tile
    if (L::NP == 1) cluster_arrive();
    // the warp's sums, cell (row gq + 8 e, unit u0 + u) of gate g at
    // v[g][2 e + u]; each part leaves the rows it does not own:
    // part[unit group][PER][lane], part kp < 2 at 2 G kp, kp >= 2 at
    // 4 G (kp - 1)
    float v[G][4];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) v[g][e] = acc_h[g][e] + acc_l[g][e];
    float* mine = part + (size_t)ug * L::PER * 32 + lane;
    if (owner) {                       // row gq + 8 (1 - kp)
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int u = 0; u < 2; ++u)
          mine[(2 * G * kp + 2 * g + u) * 32] = kp ? v[g][u] : v[g][2 + u];
    } else {
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mine[(4 * G * (kp - 1) + 4 * g + e) * 32] = v[g][e];
    }
    // the copy of step t - 2 has read this CTA's global block sq
    if (tid == 0) multicast_read_wait<1>();
    __syncthreads();
    typename Cell::Out out;
    if (owner) {
      const int e = kp;                // the owned row: gq + 8 e
      const float* theirs = part + (size_t)ug * L::PER * 32 + lane;
      float pre[G][2];
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float own = kp ? v[g][2 + u] : v[g][u];
          float sum = 0.0f;
#pragma unroll
          for (int pp = 0; pp < KS; ++pp)
            sum += pp == kp  ? own
                   : pp < 2  ? theirs[(2 * G * pp + 2 * g + u) * 32]
                             : theirs[(4 * G * (pp - 1) + 4 * g + 2 * e + u) *
                                      32];
          pre[g][u] = sum;
        }
      // every owner runs the cell, padding rows too (no divergent branch
      // in the step): row r of h_{t-1} . W^T reads row r of h only, and a
      // padding row's x, state and h0 are zero, so it stays zero and is
      // never stored
      const float2 h = Cell::cell(st, x, pre, out);
      if (more) {
        uint32_t hi, lo;
        mma::split_pair(hi, lo, h.x, h.y);
        bf16* blk = own_block(sq) + Blk::at(row, u0);
        *reinterpret_cast<uint32_t*>(blk) = hi;
        *reinterpret_cast<uint32_t*>(blk + kRows * J) = lo;
        fence_proxy_global();
      }
    }
    if (L::NP == 1) cluster_wait();
    __syncthreads();
    // h_t's block of this CTA into parity nxt of every CTA
    if (tid == 0 && more)
      multicast(atile + (nxt * C + c) * Blk::kElems, own_block(sq),
                Blk::kBytes, full + nxt, L::kMask);
    if (kLateX && more) xnext = Cell::load_x(p, s, brow, j0, t + 1, valid);
    // the step's outputs, stored while the copies are in flight, off the
    // exchange's path
    if (valid) Cell::store(p, s, st, out, brow, j0, t);
  }
  if (tid == 0) multicast_read_wait<0>();
}

// Launch L's body with `Cell` on ceil(B / 16) clusters; scratch:
// L::scratch(B) bytes.  In float32 W_hh is split into its two bf16
// planes first.
template <typename L, typename Cell>
cudaError_t launch_fwd(typename Cell::Params p, const void* w_hh,
                       void* scratch, int B, int n_steps,
                       cudaStream_t stream) {
  const mma::bf16* w = static_cast<const mma::bf16*>(w_hh);
  mma::bf16* blocks = static_cast<mma::bf16*>(scratch);
  if constexpr (L::kPlanes == 2) {
    const size_t n = (size_t)L::G * L::H * L::H;
    const cudaError_t err =
        ::cpc::rnn::split_planes(static_cast<const float*>(w_hh), blocks, n,
                                 stream);
    if (err != cudaSuccess) return err;
    w = blocks;
    blocks += 2 * n;
  }
  return ::cpc::rnn::launch<L>(fwd_cluster_kernel<L, Cell>, B, stream, p, B,
                               n_steps, w, blocks);
}

}  // namespace rnn
}  // namespace cpc
