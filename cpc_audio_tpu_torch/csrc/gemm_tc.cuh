// Block-level bf16 GEMM core for sm_90a on mma.sync (csrc/mma.cuh):
//
//   C (rows x cols) = A (rows x depth) . B (depth x cols)
//
// for one output tile of BM x BN per block, with float32 accumulators that
// stay in registers for the whole depth loop and are handed to the
// caller's epilogue with their coordinates (`Frag`).  Either operand may
// lie in device memory in either orientation: A row-major or k-major (A^T
// row-major, through ldmatrix.trans), B k-major (ldmatrix.trans) or
// n-major (B^T row-major).  Tiles are copied as they lie, 16 bytes a
// thread, into a ring of `STAGES` shared-memory slots by cp.async, so that
// tile i + STAGES - 1 is in flight while tile i multiplies.  Rows, columns
// or depth past the matrix are zero-filled, so ragged shapes need no
// special case; output coordinates past it are the epilogue's to skip.
// Every output sums its depth in one fixed order: no split-K, no atomics,
// bit-identical reruns.
//
// Float32 operands travel split into bf16 planes, a = a0 + a1 (+ a2) with
// a0 = bf16(a), a1 = bf16(a - a0), a2 = bf16(a - a0 - a1) (three planes
// hold a float32 exactly).  A product of P split terms (`Split<P>`: 3 or
// 6) walks the depth P times, one (plane of A, plane of B) pair each, as
// consecutive segments into the same ring and the same accumulators:
// 3 products keep a0 b0 + a0 b1 + a1 b0 (about 2^-16 of |a||b| lost a
// product), 6 add a0 b2 + a1 b1 + a2 b0 (about 2^-24, float32's own).
// The smallest terms come first, so the large ones round last.  P = 1
// is the plain bf16 product.
//
// Fragment layout of the accumulators acc[mi][ni][4] of a warp (mma.cuh):
// for lane = 4 g + t, acc[mi][ni][2 * half + j] is the output at
//   row = warp row origin + 16 mi + 8 half + g,
//   col = warp column origin + 8 ni + 2 t + j.
#pragma once

#include <cstddef>
#include <cstdint>

#include "mma.cuh"

namespace cpc {
namespace gemm {

using bf16 = __nv_bfloat16;

constexpr int kPad = 8;   // bf16 elements of row padding: ldmatrix rows of
                          // a slot fall into distinct banks

// A block of WM x WN warps computing a BM x BN tile, BK deep a stage.
template <int BM_, int BN_, int WM_, int WN_, int STAGES_ = 3, int BK_ = 32>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_;
  static constexpr int STAGES = STAGES_, BK = BK_;
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int WTM = BM / WM, WTN = BN / WN;   // a warp's tile
  static constexpr int MI = WTM / 16, NI = WTN / 8;     // its mma tiles
  // Blocks an SM should hold, for __launch_bounds__: room in the 64 K
  // registers for the accumulators and about 64 more a thread.
  static constexpr int kMinBlocks =
      65536 / (kThreads * (MI * NI * 4 + 64)) > 0
          ? 65536 / (kThreads * (MI * NI * 4 + 64))
          : 1;
  static_assert(WTM % 16 == 0 && WTN % 16 == 0 && BK % 16 == 0,
                "a warp owns whole m16 x n16 tiles");
  static_assert(STAGES >= 3, "at least one tile in flight beside the two "
                             "being read and refilled");
};

// Elements of one slot's operand tiles, stored as they lie in memory.
template <class T, bool A_KMAJOR>
__host__ __device__ constexpr int a_slot() {
  return A_KMAJOR ? T::BK * (T::BM + kPad) : T::BM * (T::BK + kPad);
}
template <class T, bool B_NMAJOR>
__host__ __device__ constexpr int b_slot() {
  return B_NMAJOR ? T::BN * (T::BK + kPad) : T::BK * (T::BN + kPad);
}

// Shared memory of the ring (the whole block's need; an epilogue reuses it).
template <class T, bool A_KMAJOR, bool B_NMAJOR>
__host__ __device__ constexpr size_t ring_bytes() {
  return (size_t)T::STAGES * (a_slot<T, A_KMAJOR>() + b_slot<T, B_NMAJOR>()) *
         sizeof(bf16);
}

// One batched operand: element (r, c) of its row-major storage for batch
// z at ptr[z * batch + r * ld + c]; a split operand's plane i lies `plane`
// elements past plane 0.
struct Operand {
  const bf16* ptr;
  size_t batch;
  int ld;
  size_t plane = 0;
};

// A windowed A operand (mainloop's A_WIN): its storage rows (A's rows,
// or its depth rows if k-major) stack the batches, `per` rows each.
// Storage row q is row i = (row0 + q) % per of batch (row0 + q) / per,
// and its element c lies at offset e = off + i ld + c of that batch (the
// operand's `batch` elements apart), read for 0 <= e < span and zero
// elsewhere.  Its batches are stacked in its rows, so its callers pass
// z = 0.  Every 8-element chunk must lie wholly inside [0, span) or
// outside it (off, ld and span multiples of 8).
struct Window {
  int per = 1, row0 = 0;
  long long off = 0, span = 0;
};

struct Problem {
  Operand a, b;
  int rows, cols, depth;
  Window win = {};
};

// Where a warp's accumulators sit in the output.
struct Frag {
  int row0, col0;   // the warp's first output row and column
  int g, t;         // lane = 4 g + t
  int wm, wn;       // the warp's place in the block
  __device__ int row(int mi, int half) const {
    return row0 + mi * 16 + half * 8 + g;
  }
  __device__ int col(int ni) const { return col0 + ni * 8 + 2 * t; }
};

template <class T>
__device__ __forceinline__ Frag frag(int m0, int n0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Frag f;
  f.wm = warp / T::WN;
  f.wn = warp - f.wm * T::WN;
  f.row0 = m0 + f.wm * T::WTM;
  f.col0 = n0 + f.wn * T::WTN;
  f.g = lane >> 2;
  f.t = lane & 3;
  return f;
}

// cp.async a ROWS x COLS tile of a row-major matrix (row stride ld) into a
// slot (row stride COLS + kPad); rows at or past rows_valid and 8-column
// chunks at or past cols_valid are zero-filled and not read.
template <int ROWS, int COLS, int NTHREADS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          size_t ld, int rows_valid,
                                          int cols_valid) {
  constexpr int CH = COLS / 8, N = ROWS * CH;
#pragma unroll
  for (int step = 0; step < (N + NTHREADS - 1) / NTHREADS; ++step) {
    const int i = step * NTHREADS + threadIdx.x;
    if (N % NTHREADS != 0 && i >= N) break;
    const int r = i / CH, c = (i - r * CH) * 8;
    const bool ok = r < rows_valid && c < cols_valid;
    mma::cp_async16(dst + r * (COLS + kPad) + c,
                    ok ? src + (size_t)r * ld + c : src, ok);
  }
}

// load_tile for a windowed operand (see Window): the tile's first storage
// row is q0 and its first column col0; `base` is the plane's batch 0.
template <int ROWS, int COLS, int NTHREADS>
__device__ __forceinline__ void load_tile_window(bf16* dst, const bf16* base,
                                                 size_t batch, int ld,
                                                 const Window& w, int q0,
                                                 int col0, int rows_valid,
                                                 int cols_valid) {
  constexpr int CH = COLS / 8, N = ROWS * CH;
#pragma unroll
  for (int step = 0; step < (N + NTHREADS - 1) / NTHREADS; ++step) {
    const int i = step * NTHREADS + threadIdx.x;
    if (N % NTHREADS != 0 && i >= N) break;
    const int r = i / CH, c = (i - r * CH) * 8;
    const int q = w.row0 + q0 + r;
    const int bq = q / w.per;
    const long long e =
        w.off + (long long)(q - bq * w.per) * ld + col0 + c;
    const bool ok =
        r < rows_valid && c < cols_valid && e >= 0 && e < w.span;
    mma::cp_async16(dst + r * (COLS + kPad) + c,
                    ok ? base + bq * batch + e : base, ok);
  }
}

// The (plane of A, plane of B) of segment s of a product of P split
// terms, smallest first.
template <int P>
__host__ __device__ constexpr int split_a(int s) {
  return P == 1 ? 0 : P == 3 ? (s == 0) : (0x46 >> (2 * s)) & 3;
}
template <int P>
__host__ __device__ constexpr int split_b(int s) {
  return P == 1 ? 0 : P == 3 ? (s == 1) : (0x124 >> (2 * s)) & 3;
}
static_assert(split_a<6>(0) == 2 && split_b<6>(0) == 0 &&
                  split_a<6>(1) == 1 && split_b<6>(1) == 1 &&
                  split_a<6>(2) == 0 && split_b<6>(2) == 2 &&
                  split_a<6>(3) == 1 && split_b<6>(3) == 0 &&
                  split_a<6>(4) == 0 && split_b<6>(4) == 1 &&
                  split_a<6>(5) == 0 && split_b<6>(5) == 0,
              "a2 b0, a1 b1, a0 b2, a1 b0, a0 b1, a0 b0");

// acc = A . B over the whole depth for the block's tile at (m0, n0) of
// batch z, as the sum of P split products (P = 1: bf16 operands); with
// `zero` false, acc += A . B (a product whose depth lies in several
// operands, walked one after another into the same sums).  A_WIN: A is
// read through p.win (see Window).  Leaves the ring idle (every copy
// landed, every warp past its last read), so the epilogue, or the next
// walk, may reuse `smem`.
template <class T, bool A_KMAJOR, bool B_NMAJOR, int P = 1,
          bool A_WIN = false>
__device__ __forceinline__ void mainloop(float (&acc)[T::MI][T::NI][4],
                                         const Problem& p, int z, int m0,
                                         int n0, unsigned char* smem,
                                         bool zero = true) {
  static_assert(P == 1 || P == 3 || P == 6, "1, 3 or 6 split products");
  constexpr int SA = a_slot<T, A_KMAJOR>(), SB = b_slot<T, B_NMAJOR>();
  bf16* sa = reinterpret_cast<bf16*>(smem);
  bf16* sb = sa + T::STAGES * SA;
  const bf16* A0 = p.a.ptr + (size_t)z * p.a.batch;
  const bf16* B0 = p.b.ptr + (size_t)z * p.b.batch;
  const size_t lda = p.a.ld, ldb = p.b.ld;
  const int per = (p.depth + T::BK - 1) / T::BK;   // tiles a segment

  // tile i of the walk: segment i / per, depth (i % per) BK of it
  auto load = [&](int slot, int i) {
    const int s = P == 1 ? 0 : i / per;
    const int k0 = (i - s * per) * T::BK;
    const bf16* A = A0 + split_a<P>(s) * p.a.plane;
    const bf16* B = B0 + split_b<P>(s) * p.b.plane;
    const int kv = p.depth - k0;
    if constexpr (A_WIN) {
      if (A_KMAJOR)
        load_tile_window<T::BK, T::BM, T::kThreads>(
            sa + slot * SA, A, p.a.batch, p.a.ld, p.win, k0, m0, kv,
            p.rows - m0);
      else
        load_tile_window<T::BM, T::BK, T::kThreads>(
            sa + slot * SA, A, p.a.batch, p.a.ld, p.win, m0, k0,
            p.rows - m0, kv);
    } else if (A_KMAJOR)
      load_tile<T::BK, T::BM, T::kThreads>(sa + slot * SA,
                                           A + (size_t)k0 * lda + m0, lda, kv,
                                           p.rows - m0);
    else
      load_tile<T::BM, T::BK, T::kThreads>(sa + slot * SA,
                                           A + (size_t)m0 * lda + k0, lda,
                                           p.rows - m0, kv);
    if (B_NMAJOR)
      load_tile<T::BN, T::BK, T::kThreads>(sb + slot * SB,
                                           B + (size_t)n0 * ldb + k0, ldb,
                                           p.cols - n0, kv);
    else
      load_tile<T::BK, T::BN, T::kThreads>(sb + slot * SB,
                                           B + (size_t)k0 * ldb + n0, ldb, kv,
                                           p.cols - n0);
  };

  if (zero)
#pragma unroll
    for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < T::NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;

  const Frag f = frag<T>(0, 0);
  const int wr = f.row0, wc = f.col0;   // the warp's origin in the tile
  const int n_live = p.cols - n0;       // columns of the tile that exist
  const int nk = P * per;
#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    mma::cp_async_commit();
  }
  for (int it = 0; it < nk; ++it) {
    mma::cp_async_wait<T::STAGES - 2>();
    __syncthreads();   // tile `it` landed for all; slot it - 1 is free
    const int next = it + T::STAGES - 1;
    if (next < nk) load(next % T::STAGES, next);
    mma::cp_async_commit();
    const bf16* a = sa + (it % T::STAGES) * SA;
    const bf16* b = sb + (it % T::STAGES) * SB;
#pragma unroll
    for (int ks = 0; ks < T::BK; ks += 16) {
      uint32_t af[T::MI][4];
#pragma unroll
      for (int mi = 0; mi < T::MI; ++mi) {
        if (A_KMAJOR)
          mma::load_a_kmajor(af[mi], a, T::BM + kPad, wr + mi * 16, ks);
        else
          mma::load_a(af[mi], a, T::BK + kPad, wr + mi * 16, ks);
      }
#pragma unroll
      for (int nj = 0; nj < T::NI / 2; ++nj) {
        if (wc + nj * 16 >= n_live) continue;   // past the matrix
        uint32_t bq[4];
        if (B_NMAJOR)
          mma::load_b_nmajor(bq, b, T::BK + kPad, wc + nj * 16, ks);
        else
          mma::load_b_kmajor(bq, b, T::BN + kPad, ks, wc + nj * 16);
#pragma unroll
        for (int mi = 0; mi < T::MI; ++mi) {
          mma::mma_bf16(acc[mi][2 * nj], af[mi], bq[0], bq[1]);
          mma::mma_bf16(acc[mi][2 * nj + 1], af[mi], bq[2], bq[3]);
        }
      }
    }
  }
  mma::cp_async_wait<0>();
  __syncthreads();
}

// Two neighbouring outputs (a at p, b at p + 1) in E, float32 or bf16:
// an epilogue's store of a fragment's pair.
template <class E>
__device__ __forceinline__ void store2(E* p, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<bf16>(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = mma::pack_bf16(a, b);
}

// Sums, over the block's columns, each row's values v[nv][mi][half] (a
// lane's partial over its own columns): first over the four lanes of a
// row, then over the WN warps of a warp row through `red` (NV * BM * WN
// floats of shared memory), in a fixed order.  Every lane ends with its
// rows' totals.
template <class T, int NV>
__device__ __forceinline__ void row_sums(float (&v)[NV][T::MI][2],
                                         const Frag& f, float* red) {
#pragma unroll
  for (int n = 0; n < NV; ++n)
#pragma unroll
    for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float s = v[n][mi][h];
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        v[n][mi][h] = s;
        const int r = f.wm * T::WTM + mi * 16 + h * 8 + f.g;
        if (f.t == 0) red[(n * T::BM + r) * T::WN + f.wn] = s;
      }
  __syncthreads();
#pragma unroll
  for (int n = 0; n < NV; ++n)
#pragma unroll
    for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = f.wm * T::WTM + mi * 16 + h * 8 + f.g;
        float s = 0.0f;
#pragma unroll
        for (int w = 0; w < T::WN; ++w) s += red[(n * T::BM + r) * T::WN + w];
        v[n][mi][h] = s;
      }
  __syncthreads();
}

// Column sums over the block's rows, one n8 tile at a time, so that a
// lane holds only that tile's partials: v[nv][j] is the lane's sum over
// its own rows for column col(ni) + j; col_part sums it over the eight
// lanes of the column and stores it in `red` (NV * WM * BN floats) by
// warp row; col_sums then adds the WM warp rows in a fixed order and calls
// store(nv, column in the tile, total) once for every column of the tile.
template <class T, int NV>
__device__ __forceinline__ void col_part(const float (&v)[NV][2], int ni,
                                         const Frag& f, float* red) {
#pragma unroll
  for (int n = 0; n < NV; ++n)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float s = v[n][j];
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (f.g == 0)
        red[(n * T::WM + f.wm) * T::BN + f.wn * T::WTN + ni * 8 + 2 * f.t +
            j] = s;
    }
}

template <class T, int NV, class Store>
__device__ __forceinline__ void col_sums(const float* red, Store store) {
  __syncthreads();
  for (int e = threadIdx.x; e < NV * T::BN; e += T::kThreads) {
    const int n = e / T::BN, col = e - n * T::BN;
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < T::WM; ++w) s += red[(n * T::WM + w) * T::BN + col];
    store(n, col, s);
  }
}

}  // namespace gemm
}  // namespace cpc
