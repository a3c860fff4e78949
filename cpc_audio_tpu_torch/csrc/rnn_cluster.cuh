// The thread-block-cluster bodies of the K1 and K4 recurrences
// (csrc/lstm_bwd.cu, csrc/gru_bwd.cu, and both forwards,
// csrc/rnn_cluster_fwd.cuh).
//
// Each step of a recurrence multiplies by W_hh: the forward forms the
// gates h_{t-1} . W_hh^T, each reverse step the carry
//   dh_carry[b, :] = sum_r dgates[b, r] W_hh[r, :]   (r over the G*H gate rows)
// The rows body reads all of W_hh from L2 on every step, once per batch
// row.  Here one cluster of C CTAs serves kRows = 16 batch rows (one m16
// tile; B = 32 takes two clusters) and keeps W_hh on chip for the whole
// window: CTA c owns the J = H / C hidden units J_c = [c J, c J + J) and
// their G gate rows {g H + j : j in J_c}, over all H columns (64 KB in
// bf16 for the LSTM at H = 256, 48 KB for the GRU; twice that in f32).
// C is 8, the portable cluster size, or 16 (the LSTM at H = 512 and 768,
// whose 8-CTA slice would not fit a CTA's 227 KB), which Hopper allows
// per kernel (cudaFuncAttributeNonPortableClusterSizeAllowed).
//
// The backward (`Layout`, `product_push`): a CTA has C warps, warp w
// serving the columns CTA w owns.  A step is
//   1. the elementwise part for the CTA's own units, which needs no
//      exchange: unit j's gate gradients depend only on dh[:, j], the
//      carries and the residuals (each kernel writes its own);
//   2. the partial product P_c = dgates[:, R_c] . W_hh[R_c, :], a (16, H)
//      block: bf16 on mma.sync.m16n8k16 with float32 accumulation, the
//      float32 dgates fed as the two-term split hi + lo (each exact in
//      bf16; W_hh in bf16 is exact), float32 as exact FMA loops;
//   3. a reduce-scatter over distributed shared memory: warp w pushes its
//      columns [w J, w J + J) of P_c, which CTA w owns, into CTA w's
//      receive buffer (st.shared::cluster), slot c;
//   4. one cluster barrier; the next step's elementwise part sums the C
//      slots of its own columns in a fixed order.
// The receive buffers alternate between two parities, so one barrier a
// step suffices: a CTA writes parity p only after every CTA has passed the
// barrier that ends its reads of parity p.  The residuals of step t - 1
// are copied with cp.async while step t computes, each thread copying
// only what it reads itself (so no block barrier guards them).
//
// The forward all-gathers h instead (`multicast`): each CTA writes its
// units' h, as bf16 hi and lo, to a block in global memory and hands it
// to all C CTAs with one multicast bulk copy from L2, counted by an
// mbarrier in each; no cluster barrier where the A tile has two parities.
//
// The streamed remainder (`Split`): at H = 768 a CTA's bf16 slice (192
// gate rows by 768, 295 KB) does not fit beside the rest, so each warp
// keeps the mma fragments of its first k-steps in registers, the next in
// shared memory, and streams the rest from L2 (W_hh, 4.7 MB, stays in the
// 50 MB L2) through a ring of its own every step.  The backward at H 768
// then has one receive parity and two cluster barriers a step, the first
// split in halves around the product, and loads the next step's residuals
// into registers (`StreamLayout`, csrc/lstm_bwd.cu).  The float32 LSTM at
// H 512 and 768 runs the same bodies on W_hh's two bf16 planes
// (`split_planes`), more of them streamed.
//
// No atomics, and every sum runs in a fixed order, so reruns are
// bit-identical.  What bounds it on an H100: the 128 (or 256) serial
// steps, each a partial product (0.5 MFLOP a CTA in bf16 at H 256, 1
// MFLOP at H 512, 2.4 at H 768, hi and lo), the exchange (a 16-48 KB push
// per CTA over distributed shared memory in the backward, measured at
// most of a 16-CTA step; one 2-3 KB multicast a CTA in the forward) and
// the barriers; at H 768 also 72-147 KB a CTA a step from L2.  B = 32
// runs on 2 C SMs.  port_perf/k1_step_parts.py times a step with each
// part removed.
#pragma once

#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

namespace cpc {
namespace rnn {

constexpr int kPortable = 8;       // the largest portable cluster size
constexpr int kRows = 16;          // batch rows a cluster (one m16 tile)

// A thread owns pairs of adjacent units of one batch row: pair p is row
// p / (J / 2), units 2 (p % (J / 2)) and + 1 of the CTA's J.
template <int J>
struct Pair {
  int row;    // within the cluster's kRows
  int unit;   // within the CTA's J (even)
  __device__ __forceinline__ explicit Pair(int p)
      : row(p / (J / 2)), unit(2 * (p % (J / 2))) {}
};

constexpr size_t round16(size_t n) { return (n + 15) / 16 * 16; }

// Shared-memory layout of a CTA of a C-CTA cluster: W_hh's G J rows (bf16
// with 8 elements of padding a row, so that ldmatrix rows hit distinct
// banks), the A tile of the step's dgates (bf16 hi and lo, or float32),
// the two receive parities (C, kRows, J) float32, a float32 state per own
// unit (the LSTM's dc, the GRU's dh * z) and two residual slots of SLOT
// bytes a pair.
template <typename T, int G, int J, int SLOT, int C = kPortable>
struct Layout {
  static constexpr bool kMma = sizeof(T) < sizeof(float);
  static constexpr int kCluster = C, kThreads = 32 * C;
  static constexpr int kJ = J, H = C * J, GJ = G * J;
  static constexpr int P = kRows * J / 2;
  static constexpr int ldw = kMma ? H + 8 : H;
  static constexpr int lda = kMma ? GJ + 8 : GJ + 4;
  static constexpr size_t w = 0;
  static constexpr size_t a = w + round16((size_t)GJ * ldw * sizeof(T));
  static constexpr size_t recv =
      a + round16((size_t)(kMma ? 2 : 1) * kRows * lda * sizeof(T));
  static constexpr size_t state =
      recv + (size_t)2 * C * kRows * J * sizeof(float);
  static constexpr size_t slot_bytes = round16((size_t)SLOT * P);
  static constexpr size_t ring = state + (size_t)kRows * J * sizeof(float);
  static constexpr size_t bytes = ring + 2 * slot_bytes;
};

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}

// All threads of all CTAs of the cluster: prior shared-memory writes,
// local and remote, are visible to every thread after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// cluster_sync in two halves, with work between them: after
// cluster_wait, every thread of the cluster has passed its
// cluster_arrive, and what it did before (reads of its receive buffer)
// is ordered before what follows (remote writes into that buffer).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// (x, y) to the shared memory of CTA `rank` at the address that `local`
// has in this CTA.
__device__ __forceinline__ void store_remote(const float* local, int rank,
                                             float x, float y) {
  uint32_t addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(addr)
               : "r"(mma::smem_addr(local)), "r"(rank));
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(addr),
               "f"(x), "f"(y)
               : "memory");
}

// v to the shared memory of CTA `rank` at the (16-byte aligned) address
// that `local` has in this CTA.
__device__ __forceinline__ void store_remote(const float* local, int rank,
                                             float4 v) {
  uint32_t addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(addr)
               : "r"(mma::smem_addr(local)), "r"(rank));
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   addr),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// Asynchronous copy of 4 or 8 bytes, global -> shared.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   mma::smem_addr(dst)),
               "l"(src), "n"(BYTES)
               : "memory");
}

// Two adjacent elements of T as the residual slots hold them.
template <typename T>
struct Two;
template <>
struct Two<float> {
  using type = float2;
  __device__ __forceinline__ static float2 f32(float2 v) { return v; }
  __device__ __forceinline__ static float2 zero() {
    return make_float2(0.0f, 0.0f);
  }
};
template <>
struct Two<__nv_bfloat16> {
  using type = __nv_bfloat162;
  __device__ __forceinline__ static float2 f32(__nv_bfloat162 v) {
    return __bfloat1622float2(v);
  }
  __device__ __forceinline__ static __nv_bfloat162 zero() {
    return __floats2bfloat162_rn(0.0f, 0.0f);
  }
};

template <typename T>
__device__ __forceinline__ void copy_two(typename Two<T>::type* dst,
                                         const T* src) {
  cp_async<2 * sizeof(T)>(dst, src);
}

template <typename T>
__device__ __forceinline__ float2 load_two(const T* src) {
  return Two<T>::f32(*reinterpret_cast<const typename Two<T>::type*>(src));
}

// (a, b) rounded to T at dst (bf16: to nearest, as __floats2bfloat162_rn).
__device__ __forceinline__ void store_two(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store_two(__nv_bfloat16* dst, float a,
                                          float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

// Stage the CTA's gate rows of W_hh, row g J + u = W_hh[g H + c J + u, :],
// with cp.async (the caller commits and waits).
template <typename L, typename T>
__device__ __forceinline__ void load_w(T* ws, const T* __restrict__ w_hh,
                                       int c) {
  constexpr int per = 16 / (int)sizeof(T);        // elements a 16-B chunk
  constexpr int chunks = L::H / per;              // chunks a row
  for (int idx = threadIdx.x; idx < L::GJ * chunks; idx += L::kThreads) {
    const int k = idx / chunks;
    const int q = idx - k * chunks;
    const T* src =
        w_hh + ((size_t)(k / L::kJ) * L::H + c * L::kJ + k % L::kJ) * L::H +
        q * per;
    mma::cp_async16(ws + k * L::ldw + q * per, src, true);
  }
}

// The A tile entries of gate g, units (u, u + 1) of batch row `row`:
// bf16 hi and lo of the float32 values, or the values.
template <typename L>
__device__ __forceinline__ void put_a(unsigned char* smem, int row, int g,
                                      int u, float x0, float x1) {
  const int k = g * L::kJ + u;
  if constexpr (L::kMma) {
    mma::bf16* hi = reinterpret_cast<mma::bf16*>(smem + L::a);
    mma::bf16* lo = hi + kRows * L::lda;
    uint32_t h, l;
    mma::split_pair(h, l, x0, x1);
    *reinterpret_cast<uint32_t*>(hi + row * L::lda + k) = h;
    *reinterpret_cast<uint32_t*>(lo + row * L::lda + k) = l;
  } else {
    float* a = reinterpret_cast<float*>(smem + L::a);
    *reinterpret_cast<float2*>(a + row * L::lda + k) = make_float2(x0, x1);
  }
}

// This CTA's carry from the last step's product for (row, units u, u+1):
// the C slots of parity `par`, summed in a fixed order.
template <typename L>
__device__ __forceinline__ float2 gather(const unsigned char* smem, int par,
                                         int row, int u) {
  constexpr int J = L::kJ;
  const float* r = reinterpret_cast<const float*>(smem + L::recv) +
                   (size_t)par * L::kCluster * kRows * J + row * J + u;
  float2 s = *reinterpret_cast<const float2*>(r);
#pragma unroll
  for (int c = 1; c < L::kCluster; ++c) {
    const float2 v = *reinterpret_cast<const float2*>(r + c * kRows * J);
    s.x += v.x;
    s.y += v.y;
  }
  return s;
}

// Step 2 and 3: P_c = A . W_slice, warp w's columns [w J, w J + J) pushed
// into slot c of CTA w's receive parity `par`.
template <typename L>
__device__ __forceinline__ void product_push(unsigned char* smem, int c,
                                             int par) {
  constexpr int J = L::kJ;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // this CTA's address of slot c of parity par; CTA `warp` gets the data
  float* slot = reinterpret_cast<float*>(smem + L::recv) +
                ((size_t)par * L::kCluster + c) * kRows * J;
  if constexpr (L::kMma) {
    constexpr int NT = J / 8;
    const mma::bf16* ws = reinterpret_cast<const mma::bf16*>(smem + L::w);
    const mma::bf16* hi = reinterpret_cast<const mma::bf16*>(smem + L::a);
    const mma::bf16* lo = hi + kRows * L::lda;
    // hi and lo products in separate accumulators: two dependence chains
    float acc_h[NT][4], acc_l[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_h[n][e] = acc_l[n][e] = 0.0f;
#pragma unroll
    for (int k0 = 0; k0 < L::GJ; k0 += 16) {
      uint32_t ah[4], al[4];
      mma::load_a(ah, hi, L::lda, 0, k0);
      mma::load_a(al, lo, L::lda, 0, k0);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        mma::load_b_kmajor(b, ws, L::ldw, k0, warp * J + np * 16);
        mma::mma_bf16(acc_h[2 * np], ah, b[0], b[1]);
        mma::mma_bf16(acc_l[2 * np], al, b[0], b[1]);
        mma::mma_bf16(acc_h[2 * np + 1], ah, b[2], b[3]);
        mma::mma_bf16(acc_l[2 * np + 1], al, b[2], b[3]);
      }
    }
    const int g = lane >> 2;
    const int tq = lane & 3;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int u = n * 8 + 2 * tq;
      store_remote(slot + g * J + u, warp, acc_h[n][0] + acc_l[n][0],
                   acc_h[n][1] + acc_l[n][1]);
      store_remote(slot + (g + 8) * J + u, warp, acc_h[n][2] + acc_l[n][2],
                   acc_h[n][3] + acc_l[n][3]);
    }
  } else {
    // lane = (k-slice ks, column pair cp): rows k in chunks of 4, chunk
    // ks, ks + NKS, ...; the slices meet in a xor butterfly (x + y and
    // y + x are equal, so every lane holds the same sums)
    constexpr int CP = J / 2, NKS = 32 / CP;
    const float* ws = reinterpret_cast<const float*>(smem + L::w);
    const float* a = reinterpret_cast<const float*>(smem + L::a);
    const int cp = lane % CP;
    const int ks = lane / CP;
    const int col = warp * J + 2 * cp;
    float acc[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r][0] = acc[r][1] = 0.0f;
    for (int k4 = 4 * ks; k4 < L::GJ; k4 += 4 * NKS) {
      float2 w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        w[e] = *reinterpret_cast<const float2*>(ws + (k4 + e) * L::ldw + col);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 x = *reinterpret_cast<const float4*>(a + r * L::lda + k4);
        acc[r][0] = fmaf(x.x, w[0].x, acc[r][0]);
        acc[r][1] = fmaf(x.x, w[0].y, acc[r][1]);
        acc[r][0] = fmaf(x.y, w[1].x, acc[r][0]);
        acc[r][1] = fmaf(x.y, w[1].y, acc[r][1]);
        acc[r][0] = fmaf(x.z, w[2].x, acc[r][0]);
        acc[r][1] = fmaf(x.z, w[2].y, acc[r][1]);
        acc[r][0] = fmaf(x.w, w[3].x, acc[r][0]);
        acc[r][1] = fmaf(x.w, w[3].y, acc[r][1]);
      }
    }
#pragma unroll
    for (int o = CP; o < 32; o <<= 1)
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        acc[r][0] += __shfl_xor_sync(0xffffffffu, acc[r][0], o);
        acc[r][1] += __shfl_xor_sync(0xffffffffu, acc[r][1], o);
      }
    if (ks == 0)
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        store_remote(slot + r * J + 2 * cp, warp, acc[r][0], acc[r][1]);
  }
}

// ---- the multicast all-gather -------------------------------------------
//
// A CTA hands every CTA of its cluster the same block with one bulk copy
// from global memory (L2), cp.async.bulk ... .multicast::cluster, whose
// bytes count down an mbarrier at the same shared-memory offset in each
// receiving CTA.  On an H100 at 16 CTAs this moves a 2-6 KB block a step
// in 0.55-0.86 us, where stores over distributed shared memory and a
// cluster barrier take 2.0-5.2 (port_perf/allgather.py): one thread's
// copy in place of thousands of remote stores, and no cluster barrier,
// each CTA waiting on its own mbarrier.

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   mma::smem_addr(bar)),
               "r"(count)
               : "memory");
}

// The mbarrier inits are visible to the cluster (before a cluster_sync).
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive on `bar` expecting `bytes` more bytes of copies in this phase.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          mma::smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Wait until the phase of `bar` with parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(mma::smem_addr(bar)), "r"(parity)
        : "memory");
}

// This thread's generic-proxy writes (global, or shared) are ordered
// before later async-proxy (bulk copy) accesses.
__device__ __forceinline__ void fence_proxy_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}
__device__ __forceinline__ void fence_proxy_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// `bytes` (a multiple of 16) from global `src` to shared `dst` in the
// CTAs of the cluster whose bits `mask` sets, each counting down its own
// mbarrier at `bar`.
__device__ __forceinline__ void multicast(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar,
                                          uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(
          mma::smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(mma::smem_addr(bar)),
      "h"(mask)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's bulk copies still read their
// source.
template <int N>
__device__ __forceinline__ void multicast_read_wait() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// ---- the streamed remainder ----------------------------------------------

// The k-steps (16 rows of the product's depth each) of one warp's B
// operand, W_hh's slice: the first RK held in registers as mma fragments,
// the next SK in shared memory, the last QK streamed from global memory
// (W_hh stays in the 50 MB L2) through a ring of D stages of STAGE
// elements, one k-step a stage.  Only the warp reads what it copies, so
// a stage needs cp.async.wait_group and __syncwarp, no block barrier.
// W_hh is the same every step, so the ring never drains: when the warp
// has used a stage it refills it with the k-step D later, wrapping into
// the next product's, whose first D k-steps are then in flight during
// the exchange between the two.  With QK = 0 the whole slice is
// resident and there is no ring.
template <int RK_, int SK_, int QK_, int D_, int STAGE_>
struct Split {
  static constexpr int RK = RK_, SK = SK_, QK = QK_, D = D_, STAGE = STAGE_;
  static constexpr int NR = RK + SK;                // resident k-steps
  static constexpr size_t ring_elems = QK > 0 ? (size_t)D * STAGE : 0;
  static_assert(QK == 0 || (D > 0 && QK % D == 0), "QK a multiple of D");

  // fill(stage, q) issues the cp.async copies of streamed k-step q; no
  // other cp.async group may be open while the ring runs
  template <typename Fill>
  __device__ __forceinline__ static void prime(mma::bf16* ring, Fill fill) {
    if constexpr (QK > 0) {
#pragma unroll
      for (int d = 0; d < D; ++d) {
        fill(ring + d * STAGE, d);
        mma::cp_async_commit();
      }
    }
  }

  // One product: round q takes streamed k-step q from its stage, refills
  // the stage, then runs its share of the resident k-steps (registers
  // first), so that a refill has D rounds of resident work to arrive in.
  // resident(i) runs resident k-step i < NR, streamed(q, stage) streamed
  // k-step q < QK; every loop is unrolled, so i and q are constants.
  template <typename Resident, typename Streamed, typename Fill>
  __device__ __forceinline__ static void product(mma::bf16* ring,
                                                 Resident resident,
                                                 Streamed streamed,
                                                 Fill fill) {
    if constexpr (QK == 0) {
#pragma unroll
      for (int i = 0; i < NR; ++i) resident(i);
    } else {
#pragma unroll
      for (int q = 0; q < QK; ++q) {
        mma::cp_async_wait<D - 1>();
        __syncwarp();
        mma::bf16* stage = ring + (q % D) * STAGE;
        streamed(q, stage);
        __syncwarp();
        fill(stage, (q + D) % QK);
        mma::cp_async_commit();
#pragma unroll
        for (int i = q * NR / QK; i < (q + 1) * NR / QK; ++i) resident(i);
      }
    }
  }
};

// The float32 bodies' W_hh as two bf16 planes, hi = bf16(w) and lo =
// bf16(w - hi), lo `n` elements past hi: written once a call, before the
// recurrence, so that a product of the split terms h_hi W_hi + (h_lo W_hi
// + h_hi W_lo) (3 split products; h_lo W_lo and what the two planes leave
// of w, each about 2^-16 of |h||w|, are dropped) runs on the bf16 mma
// path, and its streamed k-steps are copied as they lie.
static __global__ void __launch_bounds__(256)
    split_planes_kernel(const float* __restrict__ w,
                        mma::bf16* __restrict__ planes, size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const mma::bf16 hi = __float2bfloat16(w[i]);
    planes[i] = hi;
    planes[n + i] = __float2bfloat16(w[i] - __bfloat162float(hi));
  }
}

inline cudaError_t split_planes(const float* w, mma::bf16* planes, size_t n,
                                cudaStream_t stream) {
  const size_t blocks = (n + 255) / 256;
  split_planes_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0,
                        stream>>>(w, planes, n);
  return cudaGetLastError();
}

// Copy R rows of S 16-byte pieces into a stage of row stride LD
// (elements), the warp's lanes taking the pieces in turn; src(r) points
// at row r's first element in global memory.
template <int R, int S, int LD, typename Src>
__device__ __forceinline__ void copy_rows(mma::bf16* stage, Src src) {
  static_assert(R * S % 32 == 0, "whole pieces a lane");
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < R * S / 32; ++i) {
    const int q = lane + 32 * i;
    const int r = q / S, s = q - r * S;
    mma::cp_async16(stage + r * LD + s * 8, src(r) + s * 8, true);
  }
}

// The bf16 at p0 and p1 packed as one mma fragment register, p0's in the
// lower half.
__device__ __forceinline__ uint32_t pack_two(const mma::bf16* p0,
                                             const mma::bf16* p1) {
  return (uint32_t)*reinterpret_cast<const unsigned short*>(p0) |
         ((uint32_t)*reinterpret_cast<const unsigned short*>(p1) << 16);
}

// Launch `kernel` on ceil(B / kRows) clusters of L::kCluster CTAs.  A
// cluster that cannot be scheduled (past the portable size also on a card
// that holds no such cluster at all) makes the launch itself return
// cudaErrorClusterOutOfResources; nothing else runs instead.
template <typename L, typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int B, cudaStream_t stream, Args... args) {
  constexpr int C = L::kCluster;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (err != cudaSuccess) return err;
  if constexpr (C > kPortable) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, (B + kRows - 1) / kRows, 1);
  cfg.blockDim = dim3(L::kThreads, 1, 1);
  cfg.dynamicSmemBytes = L::bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace rnn
}  // namespace cpc
