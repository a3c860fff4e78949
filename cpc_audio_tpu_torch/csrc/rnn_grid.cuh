// The grid bodies of the K1 and K4 recurrences (csrc/lstm_fwd.cu,
// csrc/lstm_bwd.cu, csrc/gru_fwd.cu, csrc/gru_bwd.cu), at every H past
// 256 where no thread-block cluster body runs.
//
// Each step of a recurrence multiplies by W_hh: the forward forms the
// gates h_{t-1} . W_hh^T, each reverse step the carry dgates . W_hh.  The
// rows body reads all of W_hh every step once per batch row, on B SMs.
// Here one persistent kernel a call runs on as many CTAs as the card has
// SMs (read from the device, one CTA an SM, a cooperative launch), and
// W_hh is split by hidden unit over all of them, as the cluster bodies
// split it over 8 or 16 (csrc/rnn_cluster.cuh): CTA c owns the J units
// [c J, c J + J) (J even, the last CTA ragged) and their G gate rows
// {g H + j}, G = 4 (LSTM) or 3 (GRU), as the m rows g J + u of its slice.
// The whole grid reads W_hh once a step, not once per batch row.
//
// W_hh travels as PL bf16 planes: the bf16 weights themselves (exact), or
// for float32 the hi and lo planes hi = bf16(w), lo = bf16(w - hi),
// multiplied with h (or dgates) as its own bf16 hi + lo: 2 split products
// in bf16, 3 in float32 (h_hi W_hi + h_lo W_hi + h_hi W_lo; the cluster
// bodies' arithmetic, ops/lstm.py `lstm_scan_split`, ops/gru.py
// `gru_scan_split`).  A pack kernel writes them once a call into the
// scratch, each CTA's slice in the order and layout its shared memory
// takes it (`pack_fwd`, `pack_bwd`), so that every copy of a chunk is one
// contiguous run of device memory.  The products run on
// mma.sync.m16n8k16 with W_hh's gate rows (or its columns) on the 16-row
// side and the batch on the 8-column side, so B 4 fills half of an n8
// tile.  A launch takes at most
// 32 batch rows (fewer past J 32, `rows_per_launch`); the C entry points
// walk larger batches in launches of that many.
//
// Where a CTA's slice fits beside the rest, it stays in shared memory for
// the whole window (K1 at H 1056: 68 KB in bf16, 135 KB as float32's two
// planes); elsewhere (H 2048 to 8192) each warp streams its part of the
// slice every step through a ring of cp.async stages of its own, which
// never drains: a stage used is refilled with the chunk D later in the
// warp's stream of chunks, wrapping into the next step's, so the copies
// stay in flight through the cell and the barrier.  A chunk is 16
// columns of the slice (the forward's: of a warp's m-tiles; the
// backward's: of all of them, streamed in two pieces of half the m-tiles
// where 16 rings of whole chunks pass shared memory: K1 in float32 past H
// 5808 on 132 SMs), its rows 16-byte pieces, the two pieces of a row swapped
// every four rows (ldmatrix's 8 rows of a piece column hit distinct
// banks).  Past J 64 (H 8192 on a 114-SM card: J 72) a launch takes 8
// batch rows; every offset into W_hh and the activations is 64-bit (4 H^2
// is 2^28 at H 8192).
//
// Forward step (`fwd_kernel`): warp (mg, kw) multiplies m-tiles [mg MTW,
// mg MTW + MTW) of the slice by h_{t-1} over its k-groups (16 columns of
// H each), reading h's B fragments straight from a global exchange buffer
// in L2 that holds them in fragment order (one 16-byte load a lane: hi
// and lo of two registers); the KW k-parts meet in shared memory, summed
// in a fixed order by the thread that owns a pair of units of one batch
// row, which runs the cell (its state in registers), writes the outputs
// and h_t's hi and lo into the other parity of the exchange buffer.  Then
// the grid synchronises.
//
// Backward step (`bwd_kernel`): the thread that owns a pair of units of a
// batch row sums the carry of its units from every CTA's partial product
// of the last step (fixed order), runs the elementwise part and writes
// dgates as bf16 hi and lo into a shared tile; warp w then forms the
// partial carry dgates[:, R_c] . W_hh[R_c, :] over its 16-column groups of
// H (the slice's rows on the k side, read transposed by ldmatrix.trans)
// and stores each (16-column, 8-row) tile into CTA c's block of a global
// buffer in L2 as its accumulators lie, one 16-byte store a lane; each
// CTA then reads its own units' sums out of every CTA's tiles: a
// reduce-scatter through L2, as `product_push` does over distributed
// shared memory, with one grid barrier a step and two parities.  (Stored
// scattered into the owners' blocks 4 bytes at a time, the partial
// carries took 12 of a 19.7 us step at B 32 / H 1056 in bf16:
// port_perf/k1_step_parts.py --grid, NVIDIA H100 80GB HBM3, 700 W.)  No
// atomics on values, every sum in a fixed order: reruns are
// bit-identical.  dW_hh stays one matmul outside the kernel
// (ops/lstm.py, ops/gru.py), as rnn.py:224-226 and :383.
//
// The grid barrier (`grid_sync`): thread 0 of each CTA adds to one
// counter with release semantics and polls it with acquire loads.  CTA 0
// adds 2^31 - (n - 1), the others 1, so the counter's top bit flips when
// the last CTA arrives and its low bits return to what they were: a zero
// word in the scratch the wrapper keeps is left ready for the next launch,
// with no memset between calls.  The launch is cooperative: a card that
// cannot hold every CTA at once refuses it, and the wrapper raises.
//
// What bounds it on an H100: at B 32 / H 1056 a step is a partial product
// (2-3 bf16 products of 32 gate rows by 1056 by 32 a CTA), the exchange
// (a CTA reads h, 135 KB, in the forward; writes 135 KB of partials and
// reads 135 KB in the backward) and the barrier; at H 4096 and 8192 the
// stream of W_hh (134 and 537 MB in bf16, twice that in float32) from
// device memory every step, T x |W_hh| / 3.35 TB/s a call at best.
#pragma once

#include <cstdint>

#include "rnn_cluster.cuh"

namespace cpc {
namespace grid {

namespace rnn = cpc::rnn;
using bf16 = __nv_bfloat16;

constexpr int kWarps = 16, kThreads = 32 * kWarps;
constexpr int kMaxB = 32;          // batch rows a launch (4 n8 tiles)
// units a CTA: 72 takes H 8192 on a 114-SM card (64 on 132 SMs); past J
// 64 a launch takes 8 batch rows (`rows_per_launch`)
constexpr int kMaxJ = 72;
// the backward's carry, [b][J] float32: rows_per_launch(J) J <= 2
// kThreads at every J, so 2048 floats hold it (the size it had when
// kMaxJ was 64, kept so that no shape's shared memory moved)
constexpr int kCarry = 2048;
constexpr int kMinH = 257;         // the grid bodies take H past 256
constexpr size_t kRingBytes = 128 * 1024;   // a CTA's streamed stages

// The split of one launch: batch B (<= kMaxB), T steps, hidden H, G gates
// and PL planes of W_hh over the CTAs.
struct Shape {
  int B, T, H, G, PL;
  int J, ncta;     // units a CTA (even), CTAs
  int KS;          // 16-column groups of H (the last ragged at H % 16 8)
  int MT;          // m16 tiles of a CTA's G J gate rows
  int MTW, MW, KW; // forward: m-tiles a warp, warp groups over them, over
                   // k (MW KW <= 16 warps take part)
  int NT;          // n8 tiles of the batch
};

// Units a CTA: H over the SMs, rounded up to even.
inline int units(int H, int sms) {
  const int J = (H + sms - 1) / sms;
  return J + (J & 1);
}

// Batch rows a launch: a thread owns a unit pair of one row, so J / 2
// pairs of each row fill at most the CTA's threads (32 rows at J <= 32;
// fewer, in whole n8 tiles, on a card with fewer SMs).
inline int rows_per_launch(int J) {
  const int r = kThreads / (J / 2) / 8 * 8;
  return r < kMaxB ? r : kMaxB;
}

inline Shape make_shape(int B, int T, int H, int G, int PL, int sms) {
  Shape s{};
  s.B = B;
  s.T = T;
  s.H = H;
  s.G = G;
  s.PL = PL;
  s.J = units(H, sms);
  s.ncta = (H + s.J - 1) / s.J;
  s.KS = (H + 15) / 16;
  s.MT = (G * s.J + 15) / 16;
  s.MTW = s.MT >= 2 ? 2 : 1;
  s.MW = (s.MT + s.MTW - 1) / s.MTW;
  s.KW = kWarps / s.MW;
  s.NT = (B + 7) / 8;
  return s;
}

// A launch needs J <= kMaxJ and B <= rows_per_launch(J) (a thread a unit
// pair of a row), one CTA an SM for each of the ncta.
inline bool shape_ok(const Shape& s, int sms) {
  return s.B >= 1 && s.T >= 1 && s.J <= kMaxJ &&
         s.B <= rows_per_launch(s.J) && s.ncta <= sms;
}

// ---- shared memory -------------------------------------------------------
// Forward: W's chunks (resident: MW x KS of them; streamed: each warp's
// ring) and the KW k-parts' sums, [kw][32 batch rows][16 MT + 4].
// Backward: W's chunks (resident: KS; streamed: each warp's ring of
// stages, a stage a chunk or, where 16 rings of whole chunks pass shared
// memory, a piece of one), the dgates tile (bf16 hi and lo, 32 rows by 16
// MT + 8), the carry's partial sums (a float2 a thread) and the carry
// (`kCarry` floats).

__host__ __device__ inline int fwd_chunk(const Shape& s) {
  return s.PL * s.MTW * 256;          // bf16 elements
}
__host__ __device__ inline int fwd_ldp(const Shape& s) { return 16 * s.MT + 4; }
__host__ __device__ inline size_t fwd_part_bytes(const Shape& s) {
  return (size_t)s.KW * kMaxB * fwd_ldp(s) * sizeof(float);
}
__host__ __device__ inline size_t fwd_res_bytes(const Shape& s) {
  return (size_t)s.MW * s.KS * fwd_chunk(s) * 2;
}
__host__ __device__ inline bool fwd_resident(const Shape& s) {
  return fwd_res_bytes(s) + fwd_part_bytes(s) <= kSmemLimit;
}
__host__ __device__ inline size_t fwd_w_bytes(const Shape& s) {
  return fwd_resident(s) ? fwd_res_bytes(s) : kRingBytes;
}
inline size_t fwd_smem(const Shape& s) {
  return fwd_w_bytes(s) + fwd_part_bytes(s);
}

__host__ __device__ inline int bwd_chunk(const Shape& s) {
  return s.PL * s.MT * 256;           // bf16 elements
}
__host__ __device__ inline int bwd_ldg(const Shape& s) { return 16 * s.MT + 8; }
__host__ __device__ inline size_t bwd_extra_bytes(const Shape& s) {
  return (size_t)2 * kMaxB * bwd_ldg(s) * 2 + (size_t)kThreads * 8 +
         (size_t)kCarry * sizeof(float);
}
__host__ __device__ inline size_t bwd_res_bytes(const Shape& s) {
  return (size_t)s.KS * bwd_chunk(s) * 2;
}
__host__ __device__ inline bool bwd_resident(const Shape& s) {
  return bwd_res_bytes(s) + bwd_extra_bytes(s) <= kSmemLimit;
}
// The streamed backward's stages: a column group's chunk comes in `NPC`
// pieces of up to ceil(MT / NPC) m-tiles each (PL planes of them, the
// rows of each plane one run of the packed chunk); a warp's ring holds 4,
// 2 or 1 of them by their size.  One piece (the whole chunk) wherever 16
// rings of it fit; two where they do not (float32 past J 44 in K1, past
// J 58 in K4: at J 64 and 72 a K1 chunk is 16 and 18 KB, 16 stages of it
// 256 and 288 KB; H past 5808 on 132 SMs, past 5016 on 114).
__host__ __device__ inline int bwd_piece_mt(const Shape& s, int npc) {
  return (s.MT + npc - 1) / npc;
}
__host__ __device__ inline int bwd_stages_of(const Shape& s, int npc) {
  const int pm = s.PL * bwd_piece_mt(s, npc);
  return pm <= 4 ? 4 : pm <= 8 ? 2 : 1;
}
__host__ __device__ inline size_t bwd_ring_bytes(const Shape& s, int npc) {
  return (size_t)kWarps * bwd_stages_of(s, npc) * s.PL *
         bwd_piece_mt(s, npc) * 256 * 2;
}
__host__ __device__ inline int bwd_pieces(const Shape& s) {
  return bwd_ring_bytes(s, 1) + bwd_extra_bytes(s) <= kSmemLimit ? 1 : 2;
}
__host__ __device__ inline int bwd_stages(const Shape& s) {
  return bwd_stages_of(s, bwd_pieces(s));
}
__host__ __device__ inline size_t bwd_w_bytes(const Shape& s) {
  return bwd_resident(s) ? bwd_res_bytes(s)
                         : bwd_ring_bytes(s, bwd_pieces(s));
}
inline size_t bwd_smem(const Shape& s) {
  return bwd_w_bytes(s) + bwd_extra_bytes(s);
}

// ---- global scratch --------------------------------------------------------
// W_hh packed (first): each CTA's chunks in the order and layout its
// shared memory takes them (`pack_fwd`, `pack_bwd`), then the forward's
// exchange (two parities of h's B fragments: NT x KS x 32 lanes x 16
// bytes) or the backward's partial carries (two parities of each CTA's
// (16 H-column, 8 batch-row) tiles in mma accumulator order: [source]
// [KS][NT][32 lanes][4] float32).

__host__ __device__ inline size_t fwd_pack_elems(const Shape& s) {
  return (size_t)s.ncta * s.MW * s.KS * fwd_chunk(s);
}
__host__ __device__ inline size_t bwd_pack_elems(const Shape& s) {
  return (size_t)s.ncta * s.KS * bwd_chunk(s);
}
inline size_t fwd_scratch(const Shape& s) {
  return fwd_pack_elems(s) * 2 + (size_t)2 * s.NT * s.KS * 32 * 16;
}
inline size_t bwd_scratch(const Shape& s) {
  return bwd_pack_elems(s) * 2 +
         (size_t)2 * s.ncta * s.KS * s.NT * 32 * 4 * sizeof(float);
}

// ---- device helpers --------------------------------------------------------

// Element offset of (row r, column c < 16) in a chunk: rows of 16, the two
// 8-element pieces of a row swapped every four rows.
__device__ __forceinline__ int swz(int r, int half) {
  return r * 16 + ((half ^ ((r >> 2) & 1)) << 3);
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned add_release(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.add.release.gpu.global.u32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

// Every thread of every CTA: what any thread wrote before it is visible to
// every thread after it (`bar` as the header's note says).
__device__ __forceinline__ void grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned add =
        blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    __threadfence();
    const unsigned old = add_release(bar, add);
    while (((old ^ ld_acquire(bar)) & 0x80000000u) == 0) {
    }
    __threadfence();
  }
  __syncthreads();
}

// h's hi and lo for units (k, k + 1) of batch row b into parity `par` of
// the exchange: the B fragment of (n-tile b / 8, k-group k / 16), lane
// 4 (b % 8) + (k % 8) / 2, register (k % 16) / 8; 4 words a lane, hi's two
// registers then lo's.
__device__ __forceinline__ void put_h(uint32_t* exch, const Shape& s,
                                      int par, int b, int k, float2 v) {
  uint32_t hi, lo;
  mma::split_pair(hi, lo, v.x, v.y);
  const int kk = k & 15;
  const int lane = ((b & 7) << 2) | ((kk & 7) >> 1);
  uint32_t* q =
      exch +
      ((((size_t)par * s.NT + (b >> 3)) * s.KS + (k >> 4)) * 32 + lane) * 4;
  q[kk >> 3] = hi;
  q[2 + (kk >> 3)] = lo;
}

// W_hh's plane pl at gate row m (g J + u) of CTA c's slice, column k: 0
// past the slice's G J rows, past H units and past H columns.
template <typename T>
__device__ __forceinline__ bf16 w_at(const T* __restrict__ w_hh,
                                     const Shape& s, int c, int pl, int m,
                                     int k) {
  const int g = m / s.J, u = m - g * s.J, j = c * s.J + u;
  if (g >= s.G || j >= s.H || k >= s.H) return __float2bfloat16(0.0f);
  const float v = to_f32(w_hh[(size_t)(g * s.H + j) * s.H + k]);
  const bf16 hi = __float2bfloat16(v);
  return pl == 0 ? hi : __float2bfloat16(v - __bfloat162float(hi));
}

// W_hh into the forward's chunks: CTA c, warp group mg, k-group ks, PL
// planes of MTW m-tiles of 16 rows by 16 columns (`swz`); in float32 the
// planes hi = bf16(w), lo = bf16(w - hi).
template <typename T>
__global__ void __launch_bounds__(256)
    pack_fwd(const T* __restrict__ w_hh, bf16* __restrict__ out, Shape s) {
  const int CH = fwd_chunk(s), rows = CH / 16;
  const size_t n = fwd_pack_elems(s);
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t chunk = i / CH;
    const int e = (int)(i - chunk * CH);
    const int r = e / 16, col = e - r * 16;
    // undo the swap of the pieces every four rows
    const int lc = ((((col >> 3) ^ (r >> 2)) & 1) << 3) | (col & 7);
    const int ks = (int)(chunk % s.KS);
    const int mg = (int)(chunk / s.KS % s.MW);
    const int c = (int)(chunk / s.KS / s.MW);
    const int pl = r / (rows / s.PL), rr = r - pl * (rows / s.PL);
    out[i] = w_at(w_hh, s, c, pl, mg * s.MTW * 16 + rr, ks * 16 + lc);
  }
}

// W_hh into the backward's chunks: CTA c, column group cg, PL planes of
// all 16 MT gate rows by 16 columns (`swz`).
template <typename T>
__global__ void __launch_bounds__(256)
    pack_bwd(const T* __restrict__ w_hh, bf16* __restrict__ out, Shape s) {
  const int CH = bwd_chunk(s), rows = 16 * s.MT;
  const size_t n = bwd_pack_elems(s);
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t chunk = i / CH;
    const int e = (int)(i - chunk * CH);
    const int r = e / 16, col = e - r * 16;
    const int lc = ((((col >> 3) ^ (r >> 2)) & 1) << 3) | (col & 7);
    const int cg = (int)(chunk % s.KS), c = (int)(chunk / s.KS);
    const int pl = r / rows;
    out[i] = w_at(w_hh, s, c, pl, r - pl * rows, cg * 16 + lc);
  }
}

template <typename Kernel, typename T>
cudaError_t pack(Kernel kernel, const T* w_hh, bf16* out, size_t n,
                 const Shape& s, cudaStream_t stream) {
  const size_t blocks = (n + 255) / 256;
  kernel<<<(unsigned)(blocks < 8192 ? blocks : 8192), 256, 0, stream>>>(
      w_hh, out, s);
  return cudaGetLastError();
}

// Copy a chunk of `elems` bf16 (a multiple of 256) from the packed W_hh
// into shared memory, the warp's lanes taking 16-byte pieces in turn.
__device__ __forceinline__ void copy_chunk(bf16* dst, const bf16* src,
                                           int elems) {
  const int lane = threadIdx.x & 31;
  for (int q = lane; q < elems / 8; q += 32)
    mma::cp_async16(dst + q * 8, src + q * 8, true);
}

// ---- the forward -----------------------------------------------------------
//
// Cell (csrc/lstm_fwd.cu, csrc/gru_fwd.cu): T, G, Params (with h0), State
// and X (a thread's inputs of one step), and
//   init(p, s, b, k, valid) -> State
//   load_x(p, s, b, k, t, valid) -> X
//   step(p, s, State&, X, pre[G][2], b, k, t) -> h_t of units k, k + 1
// where pre holds h_{t-1} . W_hh^T of the unit pair's G gate rows.

template <class Cell, int MTW, bool RES>
__global__ void __launch_bounds__(kThreads, 1)
    fwd_kernel(typename Cell::Params p, Shape s, const bf16* __restrict__ w,
               uint32_t* __restrict__ exch, unsigned* __restrict__ bar) {
  constexpr int G = Cell::G;
  constexpr int PL = sizeof(typename Cell::T) == 2 ? 1 : 2;
  constexpr int CH = PL * MTW * 256;
  constexpr int D = RES ? 1 : (int)(kRingBytes / (kWarps * CH * 2));
  extern __shared__ __align__(16) unsigned char grid_fwd_smem[];
  bf16* wsm = reinterpret_cast<bf16*>(grid_fwd_smem);
  float* part = reinterpret_cast<float*>(grid_fwd_smem + fwd_w_bytes(s));
  const int c = blockIdx.x, tid = threadIdx.x, lane = tid & 31,
            warp = tid >> 5;
  const int J = s.J, H = s.H, KS = s.KS, NT = s.NT, B = s.B, T = s.T;
  const int u0 = c * J, LDP = fwd_ldp(s);
  // warp (mg, kw) of the MW x KW that take part; the rest idle
  const bool active = warp < s.MW * s.KW;
  const int mg = warp % s.MW, kw = warp / s.MW;
  const int kb = active ? kw * KS / s.KW : 0;
  const int Q = active ? (kw + 1) * KS / s.KW - kb : 0;
  bf16* ring = wsm + (size_t)warp * D * CH;
  // this CTA's packed chunks of warp group mg (`pack_fwd`)
  const bf16* wc = w + ((size_t)c * s.MW + mg) * KS * CH;

  // the warp's chunk of k-group ks: PL planes of its MTW m-tiles
  auto fill = [&](bf16* stage, int ks) {
    copy_chunk(stage, wc + (size_t)ks * CH, CH);
  };
  if constexpr (RES) {
    for (int q = 0; q < Q; ++q)
      fill(wsm + (size_t)(mg * KS + kb + q) * CH, kb + q);
    mma::cp_async_commit();
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      if (Q > 0) fill(ring + d * CH, kb + d % Q);
      mma::cp_async_commit();
    }
  }

  // both parities of the exchange: h0 in parity 0, zeros past B and H
  {
    const int KC = KS * 16;
    const int cb = u0, ce = c == (int)gridDim.x - 1 ? KC : u0 + J;
    const int np = (ce - cb) / 2;
    for (int idx = tid; idx < 8 * NT * np; idx += kThreads) {
      const int b = idx / np, k = cb + 2 * (idx - b * np);
      const float2 v = b < B && k < H
                           ? rnn::load_two(p.h0 + (size_t)b * H + k)
                           : make_float2(0.0f, 0.0f);
      put_h(exch, s, 0, b, k, v);
      put_h(exch, s, 1, b, k, make_float2(0.0f, 0.0f));
    }
  }
  // the thread's unit pair (k, k + 1) of batch row ib
  const int hj = J / 2;
  const int ib = tid / hj, k = u0 + 2 * (tid - ib * hj);
  const bool valid = ib < B && k < H;
  typename Cell::State st = Cell::init(p, s, ib, k, valid);
  if constexpr (RES) mma::cp_async_wait<0>();
  grid_sync(bar);

  // the ring's position in the warp's stream of chunks, which runs on
  // across steps (a step's Q chunks need not fill whole turns of it)
  int rp = 0;
  for (int t = 0; t < T; ++t) {
    const int cur = t & 1;
    // the step's inputs, in flight during the product
    const typename Cell::X x = Cell::load_x(p, s, ib, k, t, valid);
    const uint4* hx = reinterpret_cast<const uint4*>(exch) +
                      (size_t)cur * NT * KS * 32 + lane;
    auto load_h = [&](uint4 (&f)[4], int ks) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        if (nt < NT) f[nt] = __ldcg(hx + ((size_t)nt * KS + ks) * 32);
    };
    float acc[MTW][4][4];
#pragma unroll
    for (int mt = 0; mt < MTW; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
    uint4 fn[4];
    if (Q > 0) load_h(fn, kb);
    for (int q = 0; q < Q; ++q) {
      uint4 hf[4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) hf[nt] = fn[nt];
      if (q + 1 < Q) load_h(fn, kb + q + 1);
      bf16* stage;
      if constexpr (RES) {
        stage = wsm + (size_t)(mg * KS + kb + q) * CH;
      } else {
        mma::cp_async_wait<D - 1>();
        __syncwarp();
        stage = ring + (rp++ % D) * CH;
      }
      uint32_t a[MTW][PL][4];
#pragma unroll
      for (int mt = 0; mt < MTW; ++mt)
#pragma unroll
        for (int pl = 0; pl < PL; ++pl)
          mma::ldmatrix_x4(
              a[mt][pl],
              stage + swz((pl * MTW + mt) * 16 + (lane & 15), lane >> 4));
#pragma unroll
      for (int mt = 0; mt < MTW; ++mt) {
        if (mg * MTW + mt >= s.MT) continue;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (nt >= NT) continue;
          mma::mma_bf16(acc[mt][nt], a[mt][0], hf[nt].x, hf[nt].y);
          mma::mma_bf16(acc[mt][nt], a[mt][0], hf[nt].z, hf[nt].w);
          if constexpr (PL == 2)
            mma::mma_bf16(acc[mt][nt], a[mt][1], hf[nt].x, hf[nt].y);
        }
      }
      if constexpr (!RES) {
        __syncwarp();
        fill(stage, kb + (q + D) % Q);
        mma::cp_async_commit();
      }
    }
    // the warp's sums, part[kw][b][m]
    float* pk = part + (size_t)kw * kMaxB * LDP;
#pragma unroll
    for (int mt = 0; mt < MTW; ++mt) {
      if (!active || mg * MTW + mt >= s.MT) continue;
      const int m = (mg * MTW + mt) * 16 + (lane >> 2);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (nt >= NT) continue;
        const int b = nt * 8 + 2 * (lane & 3);
        pk[b * LDP + m] = acc[mt][nt][0];
        pk[(b + 1) * LDP + m] = acc[mt][nt][1];
        pk[b * LDP + m + 8] = acc[mt][nt][2];
        pk[(b + 1) * LDP + m + 8] = acc[mt][nt][3];
      }
    }
    __syncthreads();
    if (valid) {
      float pre[G][2];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float2 sum = make_float2(0.0f, 0.0f);
        const float* q = part + (size_t)ib * LDP + g * J + (k - u0);
        for (int kk = 0; kk < s.KW; ++kk) {
          const float2 v =
              *reinterpret_cast<const float2*>(q + (size_t)kk * kMaxB * LDP);
          sum.x += v.x;
          sum.y += v.y;
        }
        pre[g][0] = sum.x;
        pre[g][1] = sum.y;
      }
      const float2 h = Cell::step(p, s, st, x, pre, ib, k, t);
      if (t + 1 < T) put_h(exch, s, cur ^ 1, ib, k, h);
    }
    if (t + 1 < T) grid_sync(bar);
  }
  mma::cp_async_wait<0>();
}

// ---- the backward ----------------------------------------------------------
//
// Cell (csrc/lstm_bwd.cu, csrc/gru_bwd.cu): T, G, Params (with dhT),
// State and Res (a thread's residuals of one step, loaded a step ahead):
//   init(p, s, b, k, valid) -> State
//   load_res(p, s, b, k, t, valid) -> Res
//   step(p, s, State&, Res, carry, first, b, k, t, dg[G][2]): the
//     elementwise part from the carry summed over the CTAs (dhT at the
//     first step), writing the step's outputs; dg: the rows of the
//     product (the gradients of h . W_hh^T's G gate rows)
//   finish(p, s, State, carry, b, k): dh0 (and dc0)

// DB: the stages of a warp's ring (0: the slice resident); NPC: the
// pieces a column group's chunk streams in (`bwd_pieces`).
template <class Cell, int DB, int NPC>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_kernel(typename Cell::Params p, Shape s, const bf16* __restrict__ w,
               float* __restrict__ recv, unsigned* __restrict__ bar) {
  constexpr bool RES = DB == 0;
  static_assert(!RES || NPC == 1, "a resident slice is whole chunks");
  constexpr int G = Cell::G;
  constexpr int PL = sizeof(typename Cell::T) == 2 ? 1 : 2;
  extern __shared__ __align__(16) unsigned char grid_bwd_smem[];
  bf16* wsm = reinterpret_cast<bf16*>(grid_bwd_smem);
  const size_t wb = bwd_w_bytes(s);
  const int LDG = bwd_ldg(s);
  bf16* dgh = reinterpret_cast<bf16*>(grid_bwd_smem + wb);
  bf16* dgl = dgh + kMaxB * LDG;
  float2* gp = reinterpret_cast<float2*>(grid_bwd_smem + wb +
                                         (size_t)2 * kMaxB * LDG * 2);
  float* carry_sm = reinterpret_cast<float*>(gp + kThreads);   // [b][J]
  const int c = blockIdx.x, tid = threadIdx.x, lane = tid & 31,
            warp = tid >> 5;
  const int J = s.J, H = s.H, KS = s.KS, NT = s.NT, B = s.B, T = s.T;
  const int MT = s.MT, ncta = s.ncta, u0 = c * J;
  const int CH = bwd_chunk(s);
  // a stage: PL planes of MTP m-tiles (the whole chunk, MT, at NPC 1)
  const int MTP = bwd_piece_mt(s, NPC), PCH = PL * MTP * 256;
  const int cb = warp * KS / kWarps, Q = (warp + 1) * KS / kWarps - cb;
  bf16* ring = wsm + (size_t)warp * (RES ? 1 : DB) * PCH;
  // this CTA's packed chunks (`pack_bwd`)
  const bf16* wc = w + (size_t)c * KS * CH;

  // item i of the warp's stream of stages: piece i % NPC of column group
  // cb + i / NPC, PL planes of its m-tiles by the group's 16 columns (each
  // plane's rows one run of the chunk; `swz` rows keep their parity, the
  // runs starting at multiples of 16 rows)
  auto fill = [&](bf16* stage, int i) {
    const int cg = cb + i / NPC;
    if constexpr (NPC == 1) {
      copy_chunk(stage, wc + (size_t)cg * CH, CH);
    } else {
      const int m0 = i % NPC * MTP, nm = min(MTP, MT - m0);
      for (int pl = 0; pl < PL; ++pl)
        copy_chunk(stage + pl * MTP * 256,
                   wc + (size_t)cg * CH + (size_t)(pl * MT + m0) * 256,
                   nm * 256);
    }
  };
  if constexpr (RES) {
    for (int q = 0; q < Q; ++q) fill(wsm + (size_t)(cb + q) * CH, q);
    mma::cp_async_commit();
  } else {
#pragma unroll
    for (int d = 0; d < DB; ++d) {
      fill(ring + d * PCH, d % (Q * NPC));
      mma::cp_async_commit();
    }
  }
  for (int i = tid; i < kMaxB * LDG; i += kThreads)
    dgh[i] = dgl[i] = __float2bfloat16(0.0f);

  const int hj = J / 2;
  const int ib = tid / hj, k = u0 + 2 * (tid - ib * hj);
  const bool valid = ib < B && k < H;
  typename Cell::State st = Cell::init(p, s, ib, k, valid);
  typename Cell::Res rn = Cell::load_res(p, s, ib, k, T - 1, valid);

  // this CTA's carry of (row ib, units k, k + 1): the sum over the ncta
  // sources' partial tiles of parity par.  A gather item is one unit j of
  // a pair of batch rows (b, b + 1), which an accumulator tile holds side
  // by side (lane 4 (j % 8) + (b % 8) / 2, elements 2 ((j % 16) / 8) and
  // + 1); each group of threads sums a run of the sources, the groups in
  // order, into carry_sm[b][j]
  const int BP = (B + 1) / 2, gitems = J * BP;
  const int S = kThreads / gitems;
  const size_t per_src = (size_t)KS * NT * 128;        // floats a source
  auto gather = [&](int par) {
    const int it = tid % gitems, grp = tid / gitems;
    const int j = it % J, b = 2 * (it / J);
    const int col = u0 + j;
    if (grp < S && col < H) {
      const int r = col & 15;
      const float* base =
          recv + (size_t)par * ncta * per_src +
          (((size_t)(col >> 4) * NT + (b >> 3)) * 32 + 4 * (r & 7) +
           ((b & 7) >> 1)) * 4 + 2 * (r >> 3);
      float2 sum = make_float2(0.0f, 0.0f);
      const int s1 = (grp + 1) * ncta / S;
#pragma unroll 8
      for (int src = grp * ncta / S; src < s1; ++src) {
        const float2 v =
            __ldcg(reinterpret_cast<const float2*>(base + src * per_src));
        sum.x += v.x;
        sum.y += v.y;
      }
      gp[grp * gitems + it] = sum;
    }
    __syncthreads();
    if (tid < gitems && col < H) {
      float2 total = make_float2(0.0f, 0.0f);
      for (int g2 = 0; g2 < S; ++g2) {
        total.x += gp[g2 * gitems + tid].x;
        total.y += gp[g2 * gitems + tid].y;
      }
      carry_sm[b * J + j] = total.x;
      if (b + 1 < B) carry_sm[(b + 1) * J + j] = total.y;
    }
    __syncthreads();
    return valid ? *reinterpret_cast<const float2*>(carry_sm + ib * J +
                                                     (k - u0))
                 : make_float2(0.0f, 0.0f);
  };

  if constexpr (RES) mma::cp_async_wait<0>();
  __syncthreads();
  int rp = 0;          // the ring's position, as the forward's
  for (int t = T - 1; t >= 0; --t) {
    const bool first = t == T - 1;
    const float2 gathered = first ? make_float2(0.0f, 0.0f)
                                  : gather((t + 1) & 1);
    const typename Cell::Res r = rn;
    if (t > 0) rn = Cell::load_res(p, s, ib, k, t - 1, valid);
    if (valid) {
      const float2 carry =
          first ? *reinterpret_cast<const float2*>(p.dhT + (size_t)ib * H + k)
                : gathered;
      float dg[G][2];
      Cell::step(p, s, st, r, carry, first, ib, k, t, dg);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        uint32_t hi, lo;
        mma::split_pair(hi, lo, dg[g][0], dg[g][1]);
        const int m = g * J + (k - u0);
        *reinterpret_cast<uint32_t*>(dgh + ib * LDG + m) = hi;
        *reinterpret_cast<uint32_t*>(dgl + ib * LDG + m) = lo;
      }
    }
    __syncthreads();

    // the partial carry over the warp's column groups, each (16-column,
    // 8-row) tile stored as its accumulators lie, a 16-byte store a lane,
    // into this CTA's block of parity t & 1
    float* out = recv + ((size_t)(t & 1) * ncta + c) * per_src;
    // acc (n8 tiles 2 np, 2 np + 1) += W_hh's m-tiles [m0, m1), held by
    // the stage from its m-tile 0 on, times dgates' rows of them
    auto product = [&](float (&acc)[2][4], const bf16* stage, int np,
                       int m0, int m1) {
      for (int ks = m0; ks < m1; ++ks) {
        uint32_t a[PL][4];
#pragma unroll
        for (int pl = 0; pl < PL; ++pl)
          mma::ldmatrix_x4_trans(
              a[pl], stage + swz(pl * 16 * MTP + (ks - m0) * 16 +
                                     (lane & 7) + ((lane >> 4) << 3),
                                 (lane >> 3) & 1));
        uint32_t bh[4], bl[4];
        mma::load_b_nmajor(bh, dgh, LDG, np * 16, ks * 16);
        mma::load_b_nmajor(bl, dgl, LDG, np * 16, ks * 16);
#pragma unroll
        for (int n2 = 0; n2 < 2; ++n2) {
          if (2 * np + n2 >= NT) continue;
          mma::mma_bf16(acc[n2], a[0], bh[2 * n2], bh[2 * n2 + 1]);
          mma::mma_bf16(acc[n2], a[0], bl[2 * n2], bl[2 * n2 + 1]);
          if constexpr (PL == 2)
            mma::mma_bf16(acc[n2], a[1], bh[2 * n2], bh[2 * n2 + 1]);
        }
      }
    };
    // (column cg 16 + lane / 4 (+ 8), batch row nt 8 + 2 (lane % 4)
    // (+ 1)) in accumulator order
    auto put = [&](const float (&acc)[2][4], int cg, int np) {
#pragma unroll
      for (int n2 = 0; n2 < 2; ++n2) {
        const int nt = 2 * np + n2;
        if (nt >= NT) continue;
        *reinterpret_cast<float4*>(
            out + (((size_t)cg * NT + nt) * 32 + lane) * 4) =
            make_float4(acc[n2][0], acc[n2][1], acc[n2][2], acc[n2][3]);
      }
    };
    for (int q = 0; q < Q; ++q) {
      const int cg = cb + q;
      if constexpr (NPC == 1) {
        bf16* stage;
        if constexpr (RES) {
          stage = wsm + (size_t)cg * CH;
        } else {
          mma::cp_async_wait<DB - 1>();
          __syncwarp();
          stage = ring + (rp++ % DB) * PCH;
        }
        for (int np = 0; 2 * np < NT; ++np) {
          float acc[2][4] = {};
          product(acc, stage, np, 0, MT);
          put(acc, cg, np);
        }
        if constexpr (!RES) {
          __syncwarp();
          fill(stage, (q + DB) % Q);
          mma::cp_async_commit();
        }
      } else {
        // the column group's pieces in turn, each n8 tile's sums running
        // on across them (the order of the whole chunk's k-steps)
        float acc[2][2][4] = {};
#pragma unroll
        for (int pc = 0; pc < NPC; ++pc) {
          mma::cp_async_wait<DB - 1>();
          __syncwarp();
          bf16* stage = ring + (rp++ % DB) * PCH;
          const int m0 = pc * MTP, m1 = min(MT, m0 + MTP);
#pragma unroll
          for (int np = 0; np < 2; ++np)
            if (2 * np < NT) product(acc[np], stage, np, m0, m1);
          __syncwarp();
          fill(stage, (q * NPC + pc + DB) % (Q * NPC));
          mma::cp_async_commit();
        }
#pragma unroll
        for (int np = 0; np < 2; ++np)
          if (2 * np < NT) put(acc[np], cg, np);
      }
    }
    grid_sync(bar);
  }
  const float2 gathered = gather(0);
  if (valid) Cell::finish(p, s, st, gathered, ib, k);
  mma::cp_async_wait<0>();
}

// ---- launching -------------------------------------------------------------

inline int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  return n;
}

// One cooperative launch of `ctas` CTAs.  Where the card cannot hold them
// all at once (or has no cooperative launch) it returns the error and
// nothing runs: a barrier over CTAs that are not all resident would hang.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int ctas, size_t smem, cudaStream_t stream,
                   Args... args) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm * sms < ctas) return cudaErrorCooperativeLaunchTooLarge;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The forward over B rows in launches of at most kMaxB (`Cell::offset`
// moves the batch-major pointers to row b0).
template <class Cell>
int run_fwd(typename Cell::Params p, const void* w_hh, void* scratch,
            unsigned* bar, int B, int T, int H, cudaStream_t stream) {
  using T_ = typename Cell::T;
  constexpr int PL = sizeof(T_) == 2 ? 1 : 2;
  const int sms = sm_count();
  const int rows = rows_per_launch(units(H, sms));
  const Shape s0 = make_shape(B < rows ? B : rows, T, H, Cell::G, PL, sms);
  if (!shape_ok(s0, sms)) return (int)cudaErrorInvalidValue;
  bf16* w = static_cast<bf16*>(scratch);
  cudaError_t err = pack(pack_fwd<T_>, static_cast<const T_*>(w_hh), w,
                         fwd_pack_elems(s0), s0, stream);
  if (err != cudaSuccess) return (int)err;
  uint32_t* exch = reinterpret_cast<uint32_t*>(w + fwd_pack_elems(s0));
  for (int b0 = 0; b0 < B; b0 += rows) {
    const Shape s =
        make_shape(B - b0 < rows ? B - b0 : rows, T, H, Cell::G, PL, sms);
    const typename Cell::Params q = Cell::offset(p, s, b0);
    const size_t smem = fwd_smem(s);
    auto go = [&](auto kernel) {
      return grid::launch(kernel, s.ncta, smem, stream, q, s, w, exch, bar);
    };
    const bool res = fwd_resident(s);
    if (s.MTW == 1)
      err = res ? go(fwd_kernel<Cell, 1, true>)
                : go(fwd_kernel<Cell, 1, false>);
    else
      err = res ? go(fwd_kernel<Cell, 2, true>)
                : go(fwd_kernel<Cell, 2, false>);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <class Cell>
int run_bwd(typename Cell::Params p, const void* w_hh, void* scratch,
            unsigned* bar, int B, int T, int H, cudaStream_t stream) {
  using T_ = typename Cell::T;
  constexpr int PL = sizeof(T_) == 2 ? 1 : 2;
  const int sms = sm_count();
  const int rows = rows_per_launch(units(H, sms));
  const Shape s0 = make_shape(B < rows ? B : rows, T, H, Cell::G, PL, sms);
  if (!shape_ok(s0, sms)) return (int)cudaErrorInvalidValue;
  bf16* w = static_cast<bf16*>(scratch);
  cudaError_t err = pack(pack_bwd<T_>, static_cast<const T_*>(w_hh), w,
                         bwd_pack_elems(s0), s0, stream);
  if (err != cudaSuccess) return (int)err;
  float* recv = reinterpret_cast<float*>(w + bwd_pack_elems(s0));
  for (int b0 = 0; b0 < B; b0 += rows) {
    const Shape s =
        make_shape(B - b0 < rows ? B - b0 : rows, T, H, Cell::G, PL, sms);
    const typename Cell::Params q = Cell::offset(p, s, b0);
    const size_t smem = bwd_smem(s);
    auto go = [&](auto kernel) {
      return grid::launch(kernel, s.ncta, smem, stream, q, s, w, recv, bar);
    };
    const int stages = bwd_resident(s) ? 0 : bwd_stages(s);
    const int pieces = bwd_resident(s) ? 1 : bwd_pieces(s);
    if (pieces == 2 && stages != 1) return (int)cudaErrorInvalidValue;
    err = stages == 0   ? go(bwd_kernel<Cell, 0, 1>)
          : stages == 4 ? go(bwd_kernel<Cell, 4, 1>)
          : stages == 2 ? go(bwd_kernel<Cell, 2, 1>)
          : pieces == 1 ? go(bwd_kernel<Cell, 1, 1>)
                        : go(bwd_kernel<Cell, 1, 2>);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// Bytes of global scratch a grid body needs at (B, H) (the widest launch
// of its batch walk), and shared memory a CTA.
inline size_t scratch_bytes(bool backward, int B, int H, int G, int PL) {
  const int sms = sm_count();
  const int rows = rows_per_launch(units(H, sms));
  const Shape s = make_shape(B < rows ? B : rows, 1, H, G, PL, sms);
  return backward ? bwd_scratch(s) : fwd_scratch(s);
}

inline size_t smem_bytes(bool backward, int H, int G, int PL) {
  const Shape s = make_shape(kMaxB, 1, H, G, PL, sm_count());
  return backward ? bwd_smem(s) : fwd_smem(s);
}

}  // namespace grid
}  // namespace cpc
