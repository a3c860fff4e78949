// K3 on the tensor cores, both directions, both dtypes: the forward as
// three launches (four in float32), the backward as six GEMMs with fused
// epilogues, all on one GEMM core (csrc/gemm_tc.cuh).
//
// Replaces cpc_audio_tpu/ops/pallas/ffn.py `_tail_fwd_kernel` (called
// through `_tail_fwd`) and `_tail_bwd_kernel` (through `_tail_bwd`); the
// entry points of csrc/layer_tail_fwd.cu and csrc/layer_tail_bwd.cu call
// this body.  The math is the Pallas kernels' (ops/ffn.py
// `layer_tail_ref`, `layer_tail_bwd_ref`): per head k and row,
//   y = round(LN1(x)),  h = round(relu(y W1 + b1) r),  y2 = y + h W2 + b2
//   out = round(LN2(y2))                                  (forward)
//   dy2 = LN2'(do),     df = round(dy2),  dh = df W2^T
//   dhp = round(live ? dh / (1 - rate) : 0)   (live: kept and positive)
//   dy  = dy2 + dhp W1^T,  dx = LN1'(dy)
//   dW1 = y^T dhp, db1 = sum dhp, dW2 = h^T df, db2 = sum df,
//   dln2w = sum do yhat2, dln2b = sum do, dln1w = sum dy yhat1,
//   dln1b = sum dy,
// with r the forward's dropout factor, drawn (and in the backward drawn
// again) from dropout.cuh keyed on (k, row, f), and round() the rounding
// to the input dtype (the identity in float32).
//
// What bounds it: two products of 2 K M D F operations each in the
// forward, six in the backward (93 and 280 GFLOP at K 12, M 3712, D 256,
// F 2048: 0.094 and 0.28 ms at the bf16 peak); the inputs and outputs are
// 0.05 and 0.1 GB.  So the design spends bytes to keep the tensor cores
// fed.  The Pallas forward keeps the hidden h in VMEM; here h goes to
// device memory once and is read back once by the next GEMM (0.37 GB in
// bf16, 0.11 ms at 3.35 TB/s): a 128-row h of F 2048 is 512 KB in bf16,
// past an SM's 227 KB, and a block that chunks F instead streams all of
// W1 and W2 from L2 once a block (1.4 GB at the default shape with 64-row
// blocks).  The backward writes h and its gradient
// dhp once each and reads each twice: in bf16 the values the Pallas
// kernels multiply (they round both to the compute dtype before each
// product), about 1.1 GB, 0.33 ms at 3.35 TB/s.  Scratch: in bf16 the
// forward's is K M (D + F) bf16 (0.2 GB at the default shape), the
// backward's 2 K M (D + F) bf16 and its float32 companions.
//
// Float32 runs the same launches on bf16 tensor cores with split operands
// (csrc/gemm_tc.cuh): every float32 operand is kept as bf16 planes where
// its epilogue writes it (h, dhp, df: hi and lo; y: hi, lo and lo2, which
// hold it exactly), W1 and W2 are split once a call (`tail_split_kernel`:
// three planes of W1, two of W2), and each product sums 3 split products
// (about 2^-16 of |a||b| lost a product: a few 1e-6 of each gradient's
// norm) on three times the bf16 work, 330 TFLOP/s of float32 work at the
// bf16 peak.  G1 takes 6 (float32's own 2^-24), in both directions.  In
// the backward its sign decides which hidden units are live, and at
// 2^-16 about one unit in 1e6 lies close enough to the ReLU kink to take
// the other branch than in the exact product, each moving its row's whole
// dh into dW1, db1 and dx (1.4e-3 and 2.1e-3 of dW1's norm at one head of
// the default and the long-window shape, where 6 products flip none).  In
// the forward, G1 and G2 at 3 each put the output at 0.57-1.03 of the
// card tests' float32 tolerance (2e-5 + 2e-5 |want| against the float32
// plain version), G1 at 6 and G2 at 3 at 0.42-0.70 (the CPU emulation of
// port_perf/k3_split_accuracy.py); and the forward's h is then the
// backward's, bit for bit.  The float32 scratch: forward 3 K M D + 2 K M
// F + 5 K D F bf16 (0.5 GB at the default shape), backward 4 K M F + 5 K
// M D + 5 K D F bf16 (0.91 GB) and the companions.
//
// The launches, in order (one GEMM core, csrc/gemm_tc.cuh, used with its
// own epilogue each; G1-G6 in kernel names):
//   split `tail_split_kernel` (float32): the planes of W1 and W2;
//   LN1  `tail_ln1_kernel`: y = round(LN1(x)) and the rows' (mean, 1/std);
//   G1   y W1        -> + b1, ReLU, dropout, round: h, and in the backward
//                       the live bits;
// then the forward's
//   G2   h W2        -> a block owns all D columns of its rows: y2 = y + f +
//                       b2, LN2 statistics, out = round(LN2(y2));
// or the backward's
//   G2   h W2        -> all D columns again: y2, LN2 statistics, dy2 =
//                       LN2'(do): df, dy2 (float32), per-tile partials of
//                       db2, dln2w, dln2b;
//   G3   df W2^T     -> dhp = round(live ? dh / (1 - rate) : 0), per-tile
//                       partials of db1;
//   G4   dhp W1^T    -> all D columns again: dy = dy2 + dyf, dx = LN1'(dy)
//                       from x and the saved statistics; partials of dln1w,
//                       dln1b;
//   G5   y^T dhp     -> dW1 (float32);
//   G6   h^T df      -> dW2 (float32);
// then the per-tile partials are summed over tiles in a fixed order
// (cpc::sum_parts, csrc/scratch.cuh).  No atomics anywhere: reruns are
// bit-identical.  Up to D 1024 the G2s and G4 keep a whole D-wide row
// tile in registers (128 x 256, 64 x 512 or 32 x 1024 over 16 warps: 64
// accumulators a thread); past it (the wide body, below) they run on
// 128 x 128 tiles and hand their rows to row and column passes.
//
// Shapes: D any multiple of 8 (a row of bf16 planes is whole 16-byte
// chunks; the core zero-fills the 8-column chunks past D, and every
// epilogue skips the column pairs past it), F a multiple of 64 in bf16
// and of 32 in float32 (a warp's 32 columns of G1 and G3 make one word
// of live bits), any M (ragged tiles are zero-filled by the core).
#include <type_traits>

#include "common.cuh"
#include "dropout.cuh"
#include "gemm_tc.cuh"
#include "layer_tail_tc.cuh"
#include "scratch.cuh"

namespace cpc {

// D's width classes: class W < 3 serves D up to 256 << W with a row tile
// that holds every column, and tables of per-class instantiations are
// indexed with it; class 3 (D past kTailMaxD) is the wide body, whose
// D-wide epilogues cross column tiles (ops/ffn.py's `_width_class`
// mirrors it for the pure gate).
constexpr int kTailMaxD = 1024;    // the widest row tile
constexpr int kTailClasses = 3;    // the classes of the row-tile bodies
constexpr int kTailWide = 3;

inline int tail_width_class(int D) {
  return D <= 256 ? 0 : D <= 512 ? 1 : D <= kTailMaxD ? 2 : kTailWide;
}

namespace tail_tc {
namespace {

using bf16 = __nv_bfloat16;
namespace gm = cpc::gemm;

// vec_out's vectors: dln1w, dln1b, db2, dln2w, dln2b
constexpr int kVecs = 5;

// The tiles, chosen by timing variants on an H100 (PERF.md): 64-deep
// slots for the 128 x 128 tiles (two blocks an SM), and 16 warps, 64
// accumulators a thread, for the D-wide row tiles.  The 32 x 1024 tile
// takes 16-deep slots, four of them: 32-deep ones of G4's n-major W1
// would need 253 KB.
using TileHid = gm::Tile<128, 128, 2, 4, 3, 64>;   // G1, G3: (M, F) outputs
using TileW = gm::Tile<128, 128, 2, 4, 3, 64>;     // G5, G6: dW1, dW2
// the G2s, G4: a tile of rows by every column, D <= DM = 256 << W for D's
// width class W
template <int DM>
using TileRow = std::conditional_t<
    DM <= 256, gm::Tile<128, 256, 4, 4>,
    std::conditional_t<DM <= 512, gm::Tile<64, 512, 2, 8>,
                       gm::Tile<32, 1024, 1, 16, 4, 16>>>;

// How a body of input dtype E keeps its operands: bf16 planes of each
// (kPlanes of h, dhp, df and W2; kPlanesY of y and W1, G1's operands) and
// the split products of each GEMM (gemm_tc.cuh).
template <class E>
struct Prec;
template <>
struct Prec<bf16> {
  static constexpr int kPlanes = 1, kPlanesY = 1, kProducts = 1,
                       kProductsG1 = 1;
};
template <>
struct Prec<float> {
  static constexpr int kPlanes = 2, kPlanesY = 3, kProducts = 3,
                       kProductsG1 = 6;
};

template <class E>
struct Args {
  const E *x, *dout;
  const float *ln1w, *ln1b, *b1, *b2, *ln2w, *ln2b;
  E *dx, *out;                    // the backward's dx, the forward's out
  // bf16 planes: W1 then W2 (the inputs in bf16), y, df, h, dhp; plane i
  // of each lies i * *_plane elements past its first
  const bf16 *w1, *w2;
  bf16 *y, *df, *h, *dhp;
  size_t w_plane, y_plane, h_plane;   // K D F; K M D (y, df); K M F
  uint32_t* live;                 // (K, M, F / 32) bits of h32 > 0
  float *stats, *dy2;             // (K, M, 2) mean1, inv1; (K, M, D)
  float* rstat;                   // wide body: (K, M, 4) a row pass's
  float *vec_part, *db1_part;     // (5, K, row tiles, D); (K, hid tiles, F)
  float *dw1, *dw2;
  int K, M, D, F, row_tiles, hid_tiles;
  float eps, scale;               // scale: 1 / (1 - rate)
  cpc::Dropout drop;
};

// The scratch, carved from one allocation in 256-byte aligned pieces:
// the planes of y, df, h and dhp, in float32 those of W1 and W2, and the
// float32 companions.  The forward's (fwd) holds only y, h, the weights'
// planes and the statistics.
template <class E>
struct Scratch {
  bf16 *y, *df, *h, *dhp, *w;
  size_t w_plane, y_plane, h_plane;
  uint32_t* live;
  float *dy2, *stats, *db1_part, *rstat;
  size_t bytes;
  Scratch(unsigned char* base, int K, int M, int D, int F, bool fwd) {
    using Pr = Prec<E>;
    size_t off = 0;
    auto take = [&](size_t n) {
      unsigned char* p = base + off;
      off += (n + 255) / 256 * 256;
      return p;
    };
    const size_t rows = (size_t)K * M;
    y_plane = rows * D;
    h_plane = rows * F;
    w_plane = (size_t)K * D * F;
    auto planes = [&](int n, size_t plane) {
      return reinterpret_cast<bf16*>(take(n * plane * sizeof(bf16)));
    };
    y = planes(Pr::kPlanesY, y_plane);
    df = fwd ? nullptr : planes(Pr::kPlanes, y_plane);
    h = planes(Pr::kPlanes, h_plane);
    dhp = fwd ? nullptr : planes(Pr::kPlanes, h_plane);
    w = std::is_same<E, float>::value
            ? planes(Pr::kPlanesY + Pr::kPlanes, w_plane)
            : nullptr;
    live = fwd ? nullptr
               : reinterpret_cast<uint32_t*>(take(rows * (F / 32) * 4));
    // the wide body's y2 (forward) or y2, dy2 and dy (backward, in place)
    const bool wide = cpc::tail_width_class(D) == cpc::kTailWide;
    dy2 = fwd && !wide ? nullptr
                       : reinterpret_cast<float*>(take(rows * D * 4));
    stats = reinterpret_cast<float*>(take(rows * 2 * 4));
    const int hid = (M + TileHid::BM - 1) / TileHid::BM;
    db1_part = fwd ? nullptr
                   : reinterpret_cast<float*>(take((size_t)K * hid * F * 4));
    rstat = fwd || !wide ? nullptr
                         : reinterpret_cast<float*>(take(rows * 4 * 4));
    bytes = off;
  }
};

__device__ __forceinline__ float2 load2(const bf16* p) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  return make_float2(__low2float(v), __high2float(v));
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = mma::pack_bf16(a, b);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// N bf16 planes of the pair (a, b) at p, p + plane, ...: each the
// rounding of what the planes before it left.
template <int N>
__device__ __forceinline__ void store_split(bf16* p, size_t plane, float a,
                                            float b) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
    *reinterpret_cast<__nv_bfloat162*>(p + i * plane) = v;
    a -= __low2float(v);
    b -= __high2float(v);
  }
}

// The pair that N planes at p hold (exact for y's three).
template <int N>
__device__ __forceinline__ float2 load_split(const bf16* p, size_t plane) {
  float2 v = load2(p);
#pragma unroll
  for (int i = 1; i < N; ++i) {
    const float2 w = load2(p + i * plane);
    v.x += w.x;
    v.y += w.y;
  }
  return v;
}

template <class E>
__device__ __forceinline__ float rounded(float v) {
  return cpc::round_to<E>(v);
}

// Where row tile `tile` of head k puts its partial sums of vector v, so
// that the fixed-order sum over tiles (cpc::sum_parts) lands in vec_out's
// (5, K, D).
template <class E>
__device__ __forceinline__ size_t vec_at(const Args<E>& p, int v, int k,
                                         int tile) {
  return (((size_t)v * p.K + k) * p.row_tiles + tile) * p.D;
}

// ---- the uses: operands, orientation and epilogue --------------------------

// G1: h = round(relu(y W1 + b1) r), and in the backward (kLive) the live
// bits.  Both directions compute the same h.
template <class E, bool kLive>
struct G1_hidden {
  using T = TileHid;
  static constexpr bool kAK = false, kBN = false, kRowsFast = false;
  static constexpr int kP = Prec<E>::kProductsG1;
  static constexpr size_t kEpiBytes = 0;
  // a warp's columns make one or two words of live bits, all below F or
  // all past it (F is a multiple of 32)
  static_assert(T::WTN == 32 || T::WTN == 64, "whole words of live bits");
  __host__ __device__ static gm::Problem problem(const Args<E>& p) {
    return {{p.y, (size_t)p.M * p.D, p.D, p.y_plane},
            {p.w1, (size_t)p.D * p.F, p.F, p.w_plane}, p.M, p.F, p.D};
  }
  __device__ static void epilogue(const Args<E>& p,
                                  float (&acc)[T::MI][T::NI][4],
                                  const gm::Frag& f, int kk, int, int,
                                  unsigned char*) {
    if (f.col0 >= p.F) return;      // warp-uniform; no barrier follows
    const bool drop = p.drop.active();
    const uint32_t seed = drop ? p.drop.seed_word() : 0u;
    const float* b1 = p.b1 + (size_t)kk * p.F;
    float bias[T::NI][2];
#pragma unroll
    for (int ni = 0; ni < T::NI; ++ni) {
      bias[ni][0] = b1[f.col(ni)];
      bias[ni][1] = b1[f.col(ni) + 1];
    }
#pragma unroll
    for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = f.row(mi, hf);
        const bool ok = row < p.M;
        const size_t grow = (size_t)kk * p.M + row;
        const uint32_t key =
            cpc::dropout_row_key(seed, cpc::kSiteFFN, (uint32_t)grow);
        uint32_t bits[T::WTN / 32] = {};
#pragma unroll
        for (int ni = 0; ni < T::NI; ++ni) {
          const int c = f.col(ni);
          float v0 = fmaxf(acc[mi][ni][2 * hf] + bias[ni][0], 0.0f);
          float v1 = fmaxf(acc[mi][ni][2 * hf + 1] + bias[ni][1], 0.0f);
          if (drop) {
            v0 *= cpc::dropout_factor(key, (uint32_t)c, p.drop.threshold,
                                      p.drop.keep_scale);
            v1 *= cpc::dropout_factor(key, (uint32_t)c + 1,
                                      p.drop.threshold, p.drop.keep_scale);
          }
          if (ok)
            store_split<Prec<E>::kPlanes>(p.h + grow * p.F + c, p.h_plane,
                                          v0, v1);
          if constexpr (kLive) {
            const int bit = (ni % 4) * 8 + 2 * f.t;
            bits[ni / 4] |= ((uint32_t)(v0 > 0.0f) << bit) |
                            ((uint32_t)(v1 > 0.0f) << (bit + 1));
          }
        }
        if constexpr (kLive) {
#pragma unroll
          for (int w = 0; w < T::WTN / 32; ++w) {
            uint32_t b = bits[w];
            b |= __shfl_xor_sync(0xffffffffu, b, 1);
            b |= __shfl_xor_sync(0xffffffffu, b, 2);
            if (ok && f.t == 0)
              p.live[grow * (p.F / 32) + f.col0 / 32 + w] = b;
          }
        }
      }
  }
};

// The rows' y2 = y + f + b2 (into acc, from G2's f = h W2; y from its
// planes, exact in float32) and their LN2 mean and 1 / std (float32,
// biased variance, eps added): both G2s start so.
template <class E, class T>
__device__ __forceinline__ void ln2_stats(const Args<E>& p,
                                          float (&acc)[T::MI][T::NI][4],
                                          const gm::Frag& f, int kk,
                                          float (&mean)[T::MI][2],
                                          float (&inv)[T::MI][2],
                                          float* red) {
  const int D = p.D;
  const float* b2 = p.b2 + (size_t)kk * D;
  const size_t base = (size_t)kk * p.M;
  float st[1][T::MI][2];
#pragma unroll
  for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = f.row(mi, hf);
      st[0][mi][hf] = 0.0f;
#pragma unroll
      for (int ni = 0; ni < T::NI; ++ni) {
        const int c = f.col(ni);
        float* a = &acc[mi][ni][2 * hf];
        if (row < p.M && c < D) {
          const float2 yv = load_split<Prec<E>::kPlanesY>(
              p.y + (base + row) * D + c, p.y_plane);
          a[0] += yv.x + b2[c];
          a[1] += yv.y + b2[c + 1];
          st[0][mi][hf] += a[0] + a[1];
        }
      }
    }
  gm::row_sums<T, 1>(st, f, red);
#pragma unroll
  for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = f.row(mi, hf);
      mean[mi][hf] = st[0][mi][hf] / D;
      st[0][mi][hf] = 0.0f;
#pragma unroll
      for (int ni = 0; ni < T::NI; ++ni)
        if (row < p.M && f.col(ni) < D) {
          const float d0 = acc[mi][ni][2 * hf] - mean[mi][hf];
          const float d1 = acc[mi][ni][2 * hf + 1] - mean[mi][hf];
          st[0][mi][hf] += d0 * d0 + d1 * d1;
        }
    }
  gm::row_sums<T, 1>(st, f, red);
#pragma unroll
  for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      inv[mi][hf] = rsqrtf(st[0][mi][hf] / D + p.eps);
}

// The forward's G2: f = h W2; out = round(LN2(y + f + b2)).  The block
// owns every column of its rows.
template <class E, int DM>
struct G2_out {
  using T = TileRow<DM>;
  static constexpr bool kAK = false, kBN = false, kRowsFast = false;
  static constexpr int kP = Prec<E>::kProducts;
  static constexpr size_t kEpiBytes = T::BM * T::WN * sizeof(float);
  __host__ __device__ static gm::Problem problem(const Args<E>& p) {
    return {{p.h, (size_t)p.M * p.F, p.F, p.h_plane},
            {p.w2, (size_t)p.F * p.D, p.D, p.w_plane}, p.M, p.D, p.F};
  }
  __device__ static void epilogue(const Args<E>& p,
                                  float (&acc)[T::MI][T::NI][4],
                                  const gm::Frag& f, int kk, int, int,
                                  unsigned char* smem) {
    const int D = p.D;
    const float* lw = p.ln2w + (size_t)kk * D;
    const float* lb = p.ln2b + (size_t)kk * D;
    const size_t base = (size_t)kk * p.M;
    float mean[T::MI][2], inv[T::MI][2];
    ln2_stats<E, T>(p, acc, f, kk, mean, inv,
                    reinterpret_cast<float*>(smem));
#pragma unroll
    for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = f.row(mi, hf);
#pragma unroll
        for (int ni = 0; ni < T::NI; ++ni) {
          const int c = f.col(ni);
          if (row < p.M && c < D) {
            const float* a = &acc[mi][ni][2 * hf];
            store2(p.out + (base + row) * D + c,
                   (a[0] - mean[mi][hf]) * inv[mi][hf] * lw[c] + lb[c],
                   (a[1] - mean[mi][hf]) * inv[mi][hf] * lw[c + 1] +
                       lb[c + 1]);
          }
        }
      }
  }
};

// The backward's G2: f = h W2; y2 = y + f + b2, dy2 = LN2'(do), df =
// round(dy2); partials of db2, dln2w, dln2b.  The block owns every column
// of its rows.
template <class E, int DM>
struct G2_ln2 {
  using T = TileRow<DM>;
  static constexpr bool kAK = false, kBN = false, kRowsFast = false;
  static constexpr int kP = Prec<E>::kProducts;
  static constexpr size_t kEpiBytes =
      (2 * T::BM * T::WN + 3 * T::WM * T::BN) * sizeof(float);
  __host__ __device__ static gm::Problem problem(const Args<E>& p) {
    return {{p.h, (size_t)p.M * p.F, p.F, p.h_plane},
            {p.w2, (size_t)p.F * p.D, p.D, p.w_plane}, p.M, p.D, p.F};
  }
  __device__ static void epilogue(const Args<E>& p,
                                  float (&acc)[T::MI][T::NI][4],
                                  const gm::Frag& f, int kk, int m0, int,
                                  unsigned char* smem) {
    float* red = reinterpret_cast<float*>(smem);
    float* cred = red + 2 * T::BM * T::WN;
    const int D = p.D;
    const float* lw = p.ln2w + (size_t)kk * D;
    const size_t base = (size_t)kk * p.M;
    float s[2][T::MI][2], mean[T::MI][2], inv[T::MI][2];
    ln2_stats<E, T>(p, acc, f, kk, mean, inv, red);
    // yhat2 (in acc); the rows' sums of g = do ln2w and of g yhat2
#pragma unroll
    for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = f.row(mi, hf);
        s[0][mi][hf] = s[1][mi][hf] = 0.0f;
#pragma unroll
        for (int ni = 0; ni < T::NI; ++ni) {
          const int c = f.col(ni);
          if (row < p.M && c < D) {
            float* a = &acc[mi][ni][2 * hf];
            a[0] = (a[0] - mean[mi][hf]) * inv[mi][hf];
            a[1] = (a[1] - mean[mi][hf]) * inv[mi][hf];
            const float2 dv = load2(p.dout + (base + row) * D + c);
            const float g0 = dv.x * lw[c], g1 = dv.y * lw[c + 1];
            s[0][mi][hf] += g0 + g1;
            s[1][mi][hf] += g0 * a[0] + g1 * a[1];
          }
        }
      }
    gm::row_sums<T, 2>(s, f, red);
    // dy2 and df; the columns' sums of df, do yhat2 and do
#pragma unroll
    for (int ni = 0; ni < T::NI; ++ni) {
      const int c = f.col(ni);
      float cs[3][2] = {};
#pragma unroll
      for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = f.row(mi, hf);
          if (row < p.M && c < D) {
            const float m1 = s[0][mi][hf] / D, m2 = s[1][mi][hf] / D;
            const float* a = &acc[mi][ni][2 * hf];
            const float2 dv = load2(p.dout + (base + row) * D + c);
            const float d0 = (dv.x * lw[c] - m1 - a[0] * m2) * inv[mi][hf];
            const float d1 =
                (dv.y * lw[c + 1] - m1 - a[1] * m2) * inv[mi][hf];
            *reinterpret_cast<float2*>(p.dy2 + (base + row) * D + c) =
                make_float2(d0, d1);
            store_split<Prec<E>::kPlanes>(p.df + (base + row) * D + c,
                                          p.y_plane, d0, d1);
            cs[0][0] += rounded<E>(d0);
            cs[0][1] += rounded<E>(d1);
            cs[1][0] += dv.x * a[0];
            cs[1][1] += dv.y * a[1];
            cs[2][0] += dv.x;
            cs[2][1] += dv.y;
          }
        }
      gm::col_part<T, 3>(cs, ni, f, cred);
    }
    gm::col_sums<T, 3>(cred, [&](int n, int col, float v) {
      if (col < D) p.vec_part[vec_at(p, 2 + n, kk, m0 / T::BM) + col] = v;
    });
  }
};

// G3: dh = df W2^T; dhp = round(live ? dh / (1 - rate) : 0); partials of
// db1.
template <class E>
struct G3_dhp {
  using T = TileHid;
  static constexpr bool kAK = false, kBN = true, kRowsFast = false;
  static constexpr int kP = Prec<E>::kProducts;
  static constexpr size_t kEpiBytes = T::WM * T::BN * sizeof(float);
  __host__ __device__ static gm::Problem problem(const Args<E>& p) {
    return {{p.df, (size_t)p.M * p.D, p.D, p.y_plane},
            {p.w2, (size_t)p.F * p.D, p.D, p.w_plane}, p.M, p.F, p.D};
  }
  __device__ static void epilogue(const Args<E>& p,
                                  float (&acc)[T::MI][T::NI][4],
                                  const gm::Frag& f, int kk, int m0, int n0,
                                  unsigned char* smem) {
    const bool wok = f.col0 < p.F;   // warp-uniform, as in G1
    uint32_t word[T::MI][2][T::WTN / 32];
#pragma unroll
    for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = f.row(mi, hf);
        const uint32_t* lw =
            p.live + ((size_t)kk * p.M + row) * (p.F / 32) + f.col0 / 32;
#pragma unroll
        for (int w = 0; w < T::WTN / 32; ++w)
          word[mi][hf][w] = wok && row < p.M ? lw[w] : 0u;
      }
#pragma unroll
    for (int ni = 0; ni < T::NI; ++ni) {
      const int bit = (ni % 4) * 8 + 2 * f.t;
      float cs[1][2] = {};
#pragma unroll
      for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = f.row(mi, hf);
          const uint32_t w = word[mi][hf][ni / 4];
          const float v0 = rounded<E>(
              (w >> bit) & 1u ? acc[mi][ni][2 * hf] * p.scale : 0.0f);
          const float v1 = rounded<E>(
              (w >> (bit + 1)) & 1u ? acc[mi][ni][2 * hf + 1] * p.scale
                                    : 0.0f);
          if (wok && row < p.M)
            store_split<Prec<E>::kPlanes>(
                p.dhp + ((size_t)kk * p.M + row) * p.F + f.col(ni),
                p.h_plane, v0, v1);
          cs[0][0] += v0;
          cs[0][1] += v1;
        }
      gm::col_part<T, 1>(cs, ni, f, reinterpret_cast<float*>(smem));
    }
    float* part = p.db1_part + ((size_t)kk * p.hid_tiles + m0 / T::BM) * p.F;
    gm::col_sums<T, 1>(reinterpret_cast<float*>(smem),
                       [&](int, int col, float v) {
                         if (n0 + col < p.F) part[n0 + col] = v;
                       });
  }
};

// G4: dyf = dhp W1^T; dy = dy2 + dyf, dx = LN1'(dy); partials of dln1w,
// dln1b.  The block owns every column of its rows.
template <class E, int DM>
struct G4_dx {
  using T = TileRow<DM>;
  static constexpr bool kAK = false, kBN = true, kRowsFast = false;
  static constexpr int kP = Prec<E>::kProducts;
  static constexpr size_t kEpiBytes =
      (2 * T::BM * T::WN + 2 * T::WM * T::BN) * sizeof(float);
  __host__ __device__ static gm::Problem problem(const Args<E>& p) {
    return {{p.dhp, (size_t)p.M * p.F, p.F, p.h_plane},
            {p.w1, (size_t)p.D * p.F, p.F, p.w_plane}, p.M, p.D, p.F};
  }
  __device__ static void epilogue(const Args<E>& p,
                                  float (&acc)[T::MI][T::NI][4],
                                  const gm::Frag& f, int kk, int m0, int,
                                  unsigned char* smem) {
    float* red = reinterpret_cast<float*>(smem);
    float* cred = red + 2 * T::BM * T::WN;
    const int D = p.D;
    const float* lw = p.ln1w + (size_t)kk * D;
    const size_t base = (size_t)kk * p.M;
    float s[2][T::MI][2], mean[T::MI][2], inv[T::MI][2];
    // dy = dy2 + dyf (in acc); the rows' sums of dy ln1w and dy ln1w yhat1
#pragma unroll
    for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = f.row(mi, hf);
        const bool rok = row < p.M;
        mean[mi][hf] = rok ? p.stats[2 * (base + row)] : 0.0f;
        inv[mi][hf] = rok ? p.stats[2 * (base + row) + 1] : 0.0f;
        s[0][mi][hf] = s[1][mi][hf] = 0.0f;
#pragma unroll
        for (int ni = 0; ni < T::NI; ++ni) {
          const int c = f.col(ni);
          if (rok && c < D) {
            float* a = &acc[mi][ni][2 * hf];
            const float2 d2 =
                *reinterpret_cast<const float2*>(p.dy2 + (base + row) * D + c);
            a[0] += d2.x;
            a[1] += d2.y;
            const float2 xv = load2(p.x + (base + row) * D + c);
            const float y0 = (xv.x - mean[mi][hf]) * inv[mi][hf];
            const float y1 = (xv.y - mean[mi][hf]) * inv[mi][hf];
            s[0][mi][hf] += a[0] * lw[c] + a[1] * lw[c + 1];
            s[1][mi][hf] += a[0] * lw[c] * y0 + a[1] * lw[c + 1] * y1;
          }
        }
      }
    gm::row_sums<T, 2>(s, f, red);
    // dx; the columns' sums of dy yhat1 and dy
#pragma unroll
    for (int ni = 0; ni < T::NI; ++ni) {
      const int c = f.col(ni);
      float cs[2][2] = {};
#pragma unroll
      for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = f.row(mi, hf);
          if (row < p.M && c < D) {
            const float m1 = s[0][mi][hf] / D, m2 = s[1][mi][hf] / D;
            const float* a = &acc[mi][ni][2 * hf];
            const float2 xv = load2(p.x + (base + row) * D + c);
            const float y0 = (xv.x - mean[mi][hf]) * inv[mi][hf];
            const float y1 = (xv.y - mean[mi][hf]) * inv[mi][hf];
            store2(p.dx + (base + row) * D + c,
                   (a[0] * lw[c] - m1 - y0 * m2) * inv[mi][hf],
                   (a[1] * lw[c + 1] - m1 - y1 * m2) * inv[mi][hf]);
            cs[0][0] += a[0] * y0;
            cs[0][1] += a[1] * y1;
            cs[1][0] += a[0];
            cs[1][1] += a[1];
          }
        }
      gm::col_part<T, 2>(cs, ni, f, cred);
    }
    gm::col_sums<T, 2>(cred, [&](int n, int col, float v) {
      if (col < D) p.vec_part[vec_at(p, n, kk, m0 / T::BM) + col] = v;
    });
  }
};

// Stores a (rows x cols) float32 product tile, rows and columns past the
// product skipped.
template <class T>
__device__ __forceinline__ void store_f32(float* out, int rows, int cols,
                                          float (&acc)[T::MI][T::NI][4],
                                          const gm::Frag& f) {
#pragma unroll
  for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = f.row(mi, hf);
#pragma unroll
      for (int ni = 0; ni < T::NI; ++ni) {
        const int c = f.col(ni);
        if (row < rows && c < cols)
          *reinterpret_cast<float2*>(out + (size_t)row * cols + c) =
              make_float2(acc[mi][ni][2 * hf], acc[mi][ni][2 * hf + 1]);
      }
    }
}

// G5: dW1 = y^T dhp (D x F, depth M).
template <class E>
struct G5_dw1 {
  using T = TileW;
  static constexpr bool kAK = true, kBN = false, kRowsFast = true;
  static constexpr int kP = Prec<E>::kProducts;
  static constexpr size_t kEpiBytes = 0;
  __host__ __device__ static gm::Problem problem(const Args<E>& p) {
    return {{p.y, (size_t)p.M * p.D, p.D, p.y_plane},
            {p.dhp, (size_t)p.M * p.F, p.F, p.h_plane}, p.D, p.F, p.M};
  }
  __device__ static void epilogue(const Args<E>& p,
                                  float (&acc)[T::MI][T::NI][4],
                                  const gm::Frag& f, int kk, int, int,
                                  unsigned char*) {
    store_f32<T>(p.dw1 + (size_t)kk * p.D * p.F, p.D, p.F, acc, f);
  }
};

// G6: dW2 = h^T df (F x D, depth M).
template <class E>
struct G6_dw2 {
  using T = TileW;
  static constexpr bool kAK = true, kBN = false, kRowsFast = false;
  static constexpr int kP = Prec<E>::kProducts;
  static constexpr size_t kEpiBytes = 0;
  __host__ __device__ static gm::Problem problem(const Args<E>& p) {
    return {{p.h, (size_t)p.M * p.F, p.F, p.h_plane},
            {p.df, (size_t)p.M * p.D, p.D, p.y_plane}, p.F, p.D, p.M};
  }
  __device__ static void epilogue(const Args<E>& p,
                                  float (&acc)[T::MI][T::NI][4],
                                  const gm::Frag& f, int kk, int, int,
                                  unsigned char*) {
    store_f32<T>(p.dw2 + (size_t)kk * p.F * p.D, p.F, p.D, acc, f);
  }
};

// ---- the wide body (D past kTailMaxD) ---------------------------------------
//
// A D-wide row no longer fits one block's accumulators, so the D-wide
// products run on the 128 x 128 tiles with plain epilogues, and what
// needs a whole row goes to row passes: one warp a row for its
// statistics (the forward's whole LN2, `tail_ln2_out_kernel`; the
// backward's `tail_rows_kernel`), then, in the backward, one thread a
// column over a 32-row tile for the elementwise part and the column sums
// (`tail_cols_kernel`), whose per-tile partials cpc::sum_parts adds in a
// fixed order as before.  No atomics: reruns stay bit-identical.  The
// passes read the float32 rows from device memory two to three times
// (0.5 GB a pass at K 12, M 3712, D 2048), where the row tiles keep them
// in registers.

constexpr int kWideRows = 32;     // rows a column-pass tile

// G2 of both directions: y2 = y + h W2 + b2 (float32) into dy2.
template <class E>
struct G2_wide {
  using T = TileHid;
  static constexpr bool kAK = false, kBN = false, kRowsFast = false;
  static constexpr int kP = Prec<E>::kProducts;
  static constexpr size_t kEpiBytes = 0;
  __host__ __device__ static gm::Problem problem(const Args<E>& p) {
    return {{p.h, (size_t)p.M * p.F, p.F, p.h_plane},
            {p.w2, (size_t)p.F * p.D, p.D, p.w_plane}, p.M, p.D, p.F};
  }
  __device__ static void epilogue(const Args<E>& p,
                                  float (&acc)[T::MI][T::NI][4],
                                  const gm::Frag& f, int kk, int, int,
                                  unsigned char*) {
    const float* b2 = p.b2 + (size_t)kk * p.D;
    const size_t base = (size_t)kk * p.M;
#pragma unroll
    for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = f.row(mi, hf);
#pragma unroll
        for (int ni = 0; ni < T::NI; ++ni) {
          const int c = f.col(ni);
          if (row < p.M && c < p.D) {
            const size_t at = (base + row) * p.D + c;
            const float2 yv =
                load_split<Prec<E>::kPlanesY>(p.y + at, p.y_plane);
            store2(p.dy2 + at, acc[mi][ni][2 * hf] + yv.x + b2[c],
                   acc[mi][ni][2 * hf + 1] + yv.y + b2[c + 1]);
          }
        }
      }
  }
};

// G4: dy = dy2 + dhp W1^T, in place in dy2.
template <class E>
struct G4_wide {
  using T = TileHid;
  static constexpr bool kAK = false, kBN = true, kRowsFast = false;
  static constexpr int kP = Prec<E>::kProducts;
  static constexpr size_t kEpiBytes = 0;
  __host__ __device__ static gm::Problem problem(const Args<E>& p) {
    return {{p.dhp, (size_t)p.M * p.F, p.F, p.h_plane},
            {p.w1, (size_t)p.D * p.F, p.F, p.w_plane}, p.M, p.D, p.F};
  }
  __device__ static void epilogue(const Args<E>& p,
                                  float (&acc)[T::MI][T::NI][4],
                                  const gm::Frag& f, int kk, int, int,
                                  unsigned char*) {
    const size_t base = (size_t)kk * p.M;
#pragma unroll
    for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = f.row(mi, hf);
#pragma unroll
        for (int ni = 0; ni < T::NI; ++ni) {
          const int c = f.col(ni);
          if (row < p.M && c < p.D) {
            float* d = p.dy2 + (base + row) * p.D + c;
            const float2 v = load2(d);
            store2(d, acc[mi][ni][2 * hf] + v.x,
                   acc[mi][ni][2 * hf + 1] + v.y);
          }
        }
      }
  }
};

// ---- kernels ---------------------------------------------------------------

// One output tile of use U per block; blockIdx.z is the head.
template <class U, class E>
__global__ void __launch_bounds__(U::T::kThreads, U::T::kMinBlocks)
    tail_gemm_kernel(const Args<E> p) {
  using T = typename U::T;
  extern __shared__ __align__(128) unsigned char smem[];
  const gm::Problem pr = U::problem(p);
  const int tm = U::kRowsFast ? blockIdx.x : blockIdx.y;
  const int tn = U::kRowsFast ? blockIdx.y : blockIdx.x;
  const int m0 = tm * T::BM, n0 = tn * T::BN, kk = blockIdx.z;
  float acc[T::MI][T::NI][4];
  gm::mainloop<T, U::kAK, U::kBN, U::kP>(acc, pr, kk, m0, n0, smem);
  U::epilogue(p, acc, gm::frag<T>(m0, n0), kk, m0, n0, smem);
}

// y = round(LN1(x)) and the rows' (mean, 1 / std): one warp per row of
// D <= DM, DM / 32 elements a lane (sized by D's class: a lane's array
// sized for the widest D doubled the time of this launch at D 256).
template <class E, int DM>
__global__ void __launch_bounds__(256) tail_ln1_kernel(const Args<E> p,
                                                        int rows) {
  const int r = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const int kk = r / p.M, D = p.D;
  const E* xr = p.x + (size_t)r * D;
  float v[DM / 32];
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < DM / 32; ++i) {
    const int d = lane + 32 * i;
    v[i] = d < D ? cpc::to_f32(xr[d]) : 0.0f;
    s += v[i];
  }
  const float mean = cpc::warp_sum(s) / D;
  float q = 0.0f;
#pragma unroll
  for (int i = 0; i < DM / 32; ++i)
    if (lane + 32 * i < D) q += (v[i] - mean) * (v[i] - mean);
  const float inv = rsqrtf(cpc::warp_sum(q) / D + p.eps);
  const float* w = p.ln1w + (size_t)kk * D;
  const float* b = p.ln1b + (size_t)kk * D;
#pragma unroll
  for (int i = 0; i < DM / 32; ++i) {
    const int d = lane + 32 * i;
    if (d < D) {
      // y's planes, each the rounding of what those before it left
      float yv = (v[i] - mean) * inv * w[d] + b[d];
#pragma unroll
      for (int j = 0; j < Prec<E>::kPlanesY; ++j) {
        const bf16 h = __float2bfloat16(yv);
        p.y[j * p.y_plane + (size_t)r * D + d] = h;
        yv -= __bfloat162float(h);
      }
    }
  }
  if (lane == 0) {
    p.stats[2 * (size_t)r] = mean;
    p.stats[2 * (size_t)r + 1] = inv;
  }
}

// The float32 weights' planes, once a call: W1's three, then W2's two.
__global__ void __launch_bounds__(256)
    tail_split_kernel(const float* __restrict__ w1,
                      const float* __restrict__ w2, bf16* __restrict__ w,
                      size_t pairs, size_t plane) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < pairs;
       i += (size_t)gridDim.x * blockDim.x) {
    const float2 a = load2(w1 + 2 * i), b = load2(w2 + 2 * i);
    store_split<3>(w + 2 * i, plane, a.x, a.y);
    store_split<2>(w + 3 * plane + 2 * i, plane, b.x, b.y);
  }
}

// y = round(LN1(x)) and the rows' (mean, 1 / std) at any D: one warp per
// row, reading it from device memory once for each of three passes.
template <class E>
__global__ void __launch_bounds__(256) tail_ln1_wide_kernel(const Args<E> p,
                                                             int rows) {
  const int r = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const int kk = r / p.M, D = p.D;
  const E* xr = p.x + (size_t)r * D;
  float s = 0.0f;
  for (int d = lane; d < D; d += 32) s += cpc::to_f32(xr[d]);
  const float mean = cpc::warp_sum(s) / D;
  float q = 0.0f;
  for (int d = lane; d < D; d += 32) {
    const float v = cpc::to_f32(xr[d]) - mean;
    q += v * v;
  }
  const float inv = rsqrtf(cpc::warp_sum(q) / D + p.eps);
  const float* w = p.ln1w + (size_t)kk * D;
  const float* b = p.ln1b + (size_t)kk * D;
  for (int d = lane; d < D; d += 32) {
    float yv = (cpc::to_f32(xr[d]) - mean) * inv * w[d] + b[d];
#pragma unroll
    for (int j = 0; j < Prec<E>::kPlanesY; ++j) {
      const bf16 h = __float2bfloat16(yv);
      p.y[j * p.y_plane + (size_t)r * D + d] = h;
      yv -= __bfloat162float(h);
    }
  }
  if (lane == 0) {
    p.stats[2 * (size_t)r] = mean;
    p.stats[2 * (size_t)r + 1] = inv;
  }
}

// The wide body's forward LN2, one warp a row: out = round(LN2(y2)), y2
// in dy2, read from device memory once for each of three passes.
template <class E>
__global__ void __launch_bounds__(256) tail_ln2_out_kernel(const Args<E> p,
                                                            int rows) {
  const int r = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const int kk = r / p.M, D = p.D;
  const float* v = p.dy2 + (size_t)r * D;
  float s = 0.0f;
  for (int d = lane; d < D; d += 32) s += v[d];
  const float mean = cpc::warp_sum(s) / D;
  float q = 0.0f;
  for (int d = lane; d < D; d += 32) q += (v[d] - mean) * (v[d] - mean);
  const float inv = rsqrtf(cpc::warp_sum(q) / D + p.eps);
  const float* lw = p.ln2w + (size_t)kk * D;
  const float* lb = p.ln2b + (size_t)kk * D;
  E* o = p.out + (size_t)r * D;
  for (int d = lane; d < D; d += 32)
    o[d] = cpc::from_f32<E>((v[d] - mean) * inv * lw[d] + lb[d]);
}

// The wide body's backward row passes, one warp a row of D:
//   kLn2Bwd: rstat = (mean2, inv2, mean(g), mean(g yhat2)), g = do ln2w,
//            y2 in dy2;
//   kLn1Bwd: rstat = (mean1, inv1, mean(a), mean(a yhat1)), a = dy ln1w,
//            dy in dy2, LN1's saved statistics.
enum WidePass { kLn2Bwd, kLn1Bwd };

template <class E, int kMode>
__global__ void __launch_bounds__(256) tail_rows_kernel(const Args<E> p,
                                                         int rows) {
  const int r = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const int kk = r / p.M, D = p.D;
  const float* v = p.dy2 + (size_t)r * D;
  float mean, inv;
  if (kMode == kLn1Bwd) {
    mean = p.stats[2 * (size_t)r];
    inv = p.stats[2 * (size_t)r + 1];
  } else {
    float s = 0.0f;
    for (int d = lane; d < D; d += 32) s += v[d];
    mean = cpc::warp_sum(s) / D;
    float q = 0.0f;
    for (int d = lane; d < D; d += 32) q += (v[d] - mean) * (v[d] - mean);
    inv = rsqrtf(cpc::warp_sum(q) / D + p.eps);
  }
  const float* lw = (kMode == kLn2Bwd ? p.ln2w : p.ln1w) + (size_t)kk * D;
  float s0 = 0.0f, s1 = 0.0f;
  for (int d = lane; d < D; d += 32) {
    float a, yhat;
    if (kMode == kLn2Bwd) {
      a = cpc::to_f32(p.dout[(size_t)r * D + d]) * lw[d];
      yhat = (v[d] - mean) * inv;
    } else {
      a = v[d] * lw[d];
      yhat = (cpc::to_f32(p.x[(size_t)r * D + d]) - mean) * inv;
    }
    s0 += a;
    s1 += a * yhat;
  }
  s0 = cpc::warp_sum(s0);
  s1 = cpc::warp_sum(s1);
  if (lane == 0)
    *reinterpret_cast<float4*>(p.rstat + 4 * (size_t)r) =
        make_float4(mean, inv, s0 / D, s1 / D);
}

// The wide body's column passes, one thread a column of a kWideRows-row
// tile (blockIdx.y) of head blockIdx.z, from tail_rows_kernel's rstat:
//   kLn2Bwd: dy2 = LN2'(do) in place of y2, df's planes; the tile's
//            partials of db2, dln2w, dln2b;
//   kLn1Bwd: dx = LN1'(dy); the tile's partials of dln1w, dln1b.
template <class E, int kMode>
__global__ void __launch_bounds__(256) tail_cols_kernel(const Args<E> p) {
  const int c = blockIdx.x * 256 + threadIdx.x;
  const int tile = blockIdx.y, kk = blockIdx.z, D = p.D;
  if (c >= D) return;
  const size_t base = (size_t)kk * p.M;
  const float lw = (kMode == kLn2Bwd ? p.ln2w : p.ln1w)[(size_t)kk * D + c];
  float cs[3] = {};
  const int r1 = min(p.M, (tile + 1) * kWideRows);
  for (int row = tile * kWideRows; row < r1; ++row) {
    const size_t at = (base + row) * D + c;
    const float4 st =
        *reinterpret_cast<const float4*>(p.rstat + 4 * (base + row));
    if (kMode == kLn2Bwd) {
      const float yhat = (p.dy2[at] - st.x) * st.y;
      const float dv = cpc::to_f32(p.dout[at]);
      const float d = (dv * lw - st.z - yhat * st.w) * st.y;
      p.dy2[at] = d;
      float rest = d;
#pragma unroll
      for (int j = 0; j < Prec<E>::kPlanes; ++j) {
        const bf16 h = __float2bfloat16(rest);
        p.df[j * p.y_plane + at] = h;
        rest -= __bfloat162float(h);
      }
      cs[0] += rounded<E>(d);
      cs[1] += dv * yhat;
      cs[2] += dv;
    } else {
      const float a = p.dy2[at];
      const float y0 = (cpc::to_f32(p.x[at]) - st.x) * st.y;
      p.dx[at] = cpc::from_f32<E>((a * lw - st.z - y0 * st.w) * st.y);
      cs[0] += a * y0;
      cs[1] += a;
    }
  }
  const int v0 = kMode == kLn2Bwd ? 2 : 0, nv = kMode == kLn2Bwd ? 3 : 2;
  for (int n = 0; n < nv; ++n)
    p.vec_part[vec_at(p, v0 + n, kk, tile) + c] = cs[n];
}

template <class U, class E>
cudaError_t run(const Args<E>& p, int K, cudaStream_t stream) {
  using T = typename U::T;
  constexpr size_t smem = gm::ring_bytes<T, U::kAK, U::kBN>();
  static_assert(U::kEpiBytes <= smem, "the epilogue reuses the ring");
  auto kernel = tail_gemm_kernel<U, E>;
  const cudaError_t err = cpc::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const gm::Problem pr = U::problem(p);
  const int tm = (pr.rows + T::BM - 1) / T::BM;
  const int tn = (pr.cols + T::BN - 1) / T::BN;
  const dim3 grid = U::kRowsFast ? dim3(tm, tn, K) : dim3(tn, tm, K);
  kernel<<<grid, T::kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <class T, bool AK, bool BN>
constexpr size_t ring() {
  return gm::ring_bytes<T, AK, BN>();
}
constexpr size_t cmax(size_t a, size_t b) { return a > b ? a : b; }

template <int DM>
constexpr size_t smem_for() {
  return cmax(cmax(cmax(ring<TileHid, false, false>(),
                        ring<TileHid, false, true>()),
                   ring<TileW, true, false>()),
              cmax(ring<TileRow<DM>, false, false>(),
                   ring<TileRow<DM>, false, true>()));
}

// What both directions read and write: the inputs, and the scratch `sc`
// (in float32 also the weights' planes, which split_and_ln1 writes).
template <class E>
Args<E> args_for(const Scratch<E>& sc, const void* x, const float* ln1w,
                 const float* ln1b, const void* w1, const float* b1,
                 const void* w2, const float* b2, const float* ln2w,
                 const float* ln2b, int K, int M, int D, int F, float eps,
                 cpc::Dropout drop) {
  constexpr bool kF32 = std::is_same<E, float>::value;
  Args<E> p = {};
  p.x = static_cast<const E*>(x);
  p.ln1w = ln1w;
  p.ln1b = ln1b;
  p.b1 = b1;
  p.b2 = b2;
  p.ln2w = ln2w;
  p.ln2b = ln2b;
  p.w1 = kF32 ? sc.w : static_cast<const bf16*>(w1);
  p.w2 = kF32 ? sc.w + Prec<E>::kPlanesY * sc.w_plane
              : static_cast<const bf16*>(w2);
  p.y = sc.y;
  p.df = sc.df;
  p.h = sc.h;
  p.dhp = sc.dhp;
  p.w_plane = sc.w_plane;
  p.y_plane = sc.y_plane;
  p.h_plane = sc.h_plane;
  p.live = sc.live;
  p.stats = sc.stats;
  p.dy2 = sc.dy2;
  p.rstat = sc.rstat;
  p.db1_part = sc.db1_part;
  p.K = K;
  p.M = M;
  p.D = D;
  p.F = F;
  p.row_tiles = row_tiles(M, D);
  p.hid_tiles = (M + TileHid::BM - 1) / TileHid::BM;
  p.eps = eps;
  p.scale = drop.seed != nullptr ? drop.keep_scale : 1.0f;
  p.drop = drop;
  return p;
}

// The launches both directions start with: in float32 the weights'
// planes, then LN1 by D's width class.
template <class E>
cudaError_t split_and_ln1(const Args<E>& p, const Scratch<E>& sc,
                          const void* w1, const void* w2,
                          cudaStream_t stream) {
  if (std::is_same<E, float>::value) {
    const size_t pairs = sc.w_plane / 2;
    tail_split_kernel<<<dim3((unsigned)((pairs + 255) / 256)), 256, 0,
                        stream>>>(static_cast<const float*>(w1),
                                  static_cast<const float*>(w2), sc.w, pairs,
                                  sc.w_plane);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const decltype(&tail_ln1_kernel<E, 256>) kLn1[cpc::kTailClasses + 1] = {
      tail_ln1_kernel<E, 256>, tail_ln1_kernel<E, 512>,
      tail_ln1_kernel<E, 1024>, tail_ln1_wide_kernel<E>};
  const int rows = p.K * p.M;
  kLn1[cpc::tail_width_class(p.D)]<<<dim3((rows + 7) / 8), 256, 0, stream>>>(
      p, rows);
  return cudaGetLastError();
}

// The wide body's forward LN2 over all K M rows.
template <class E>
cudaError_t ln2_out_pass(const Args<E>& p, cudaStream_t stream) {
  const int rows = p.K * p.M;
  tail_ln2_out_kernel<E><<<dim3((rows + 7) / 8), 256, 0, stream>>>(p, rows);
  return cudaGetLastError();
}

// A backward row pass of the wide body over all K M rows.
template <class E, int kMode>
cudaError_t rows_pass(const Args<E>& p, cudaStream_t stream) {
  const int rows = p.K * p.M;
  tail_rows_kernel<E, kMode><<<dim3((rows + 7) / 8), 256, 0, stream>>>(
      p, rows);
  return cudaGetLastError();
}

// A column pass of the wide body: 256 columns by kWideRows rows a block.
template <class E, int kMode>
cudaError_t cols_pass(const Args<E>& p, cudaStream_t stream) {
  const dim3 grid((p.D + 255) / 256, p.row_tiles, p.K);
  tail_cols_kernel<E, kMode><<<grid, 256, 0, stream>>>(p);
  return cudaGetLastError();
}

template <class E>
int launch_fwd_body(const void* x, const float* ln1w, const float* ln1b,
                    const void* w1, const float* b1, const void* w2,
                    const float* b2, const float* ln2w, const float* ln2b,
                    void* out, void* scratch, int K, int M, int D, int F,
                    float eps, cpc::Dropout drop, cudaStream_t stream) {
  const Scratch<E> sc(static_cast<unsigned char*>(scratch), K, M, D, F,
                      true);
  Args<E> p = args_for<E>(sc, x, ln1w, ln1b, w1, b1, w2, b2, ln2w, ln2b, K,
                          M, D, F, eps, drop);
  p.out = static_cast<E*>(out);
  const decltype(&run<G2_out<E, 256>, E>) kG2[cpc::kTailClasses] = {
      run<G2_out<E, 256>, E>, run<G2_out<E, 512>, E>,
      run<G2_out<E, 1024>, E>};
  const bool wide = cpc::tail_width_class(D) == cpc::kTailWide;
  cudaError_t err = split_and_ln1(p, sc, w1, w2, stream);
  if (err == cudaSuccess) err = run<G1_hidden<E, false>, E>(p, K, stream);
  if (wide) {
    if (err == cudaSuccess) err = run<G2_wide<E>, E>(p, K, stream);
    if (err == cudaSuccess) err = ln2_out_pass<E>(p, stream);
  } else if (err == cudaSuccess) {
    err = kG2[cpc::tail_width_class(D)](p, K, stream);
  }
  return (int)err;
}

template <class E>
int launch_bwd_body(const void* x, const float* ln1w, const float* ln1b,
                    const void* w1, const float* b1, const void* w2,
                    const float* b2, const float* ln2w, const float* ln2b,
                    const void* dout, void* dx, float* vec_part,
                    float* vec_out, float* dw1, float* db1, float* dw2,
                    void* scratch, int K, int M, int D, int F, float eps,
                    cpc::Dropout drop, cudaStream_t stream) {
  const Scratch<E> sc(static_cast<unsigned char*>(scratch), K, M, D, F,
                      false);
  Args<E> p = args_for<E>(sc, x, ln1w, ln1b, w1, b1, w2, b2, ln2w, ln2b, K,
                          M, D, F, eps, drop);
  p.dout = static_cast<const E*>(dout);
  p.dx = static_cast<E*>(dx);
  p.vec_part = vec_part;
  p.dw1 = dw1;
  p.dw2 = dw2;

  // G2 and G4 by D's width class
  const decltype(&run<G2_ln2<E, 256>, E>) kG2[cpc::kTailClasses] = {
      run<G2_ln2<E, 256>, E>, run<G2_ln2<E, 512>, E>,
      run<G2_ln2<E, 1024>, E>};
  const decltype(&run<G4_dx<E, 256>, E>) kG4[cpc::kTailClasses] = {
      run<G4_dx<E, 256>, E>, run<G4_dx<E, 512>, E>, run<G4_dx<E, 1024>, E>};
  const int w = cpc::tail_width_class(D);
  const bool wide = w == cpc::kTailWide;
  cudaError_t err = split_and_ln1(p, sc, w1, w2, stream);
  if (err == cudaSuccess) err = run<G1_hidden<E, true>, E>(p, K, stream);
  if (wide) {
    if (err == cudaSuccess) err = run<G2_wide<E>, E>(p, K, stream);
    if (err == cudaSuccess) err = rows_pass<E, kLn2Bwd>(p, stream);
    if (err == cudaSuccess) err = cols_pass<E, kLn2Bwd>(p, stream);
  } else if (err == cudaSuccess) {
    err = kG2[w](p, K, stream);
  }
  if (err == cudaSuccess) err = run<G3_dhp<E>, E>(p, K, stream);
  if (wide) {
    if (err == cudaSuccess) err = run<G4_wide<E>, E>(p, K, stream);
    if (err == cudaSuccess) err = rows_pass<E, kLn1Bwd>(p, stream);
    if (err == cudaSuccess) err = cols_pass<E, kLn1Bwd>(p, stream);
  } else if (err == cudaSuccess) {
    err = kG4[w](p, K, stream);
  }
  if (err == cudaSuccess) err = run<G5_dw1<E>, E>(p, K, stream);
  if (err == cudaSuccess) err = run<G6_dw2<E>, E>(p, K, stream);
  if (err == cudaSuccess)
    err = cpc::sum_parts(vec_part, vec_out, p.row_tiles, D, kVecs * K,
                         stream);
  if (err == cudaSuccess)
    err = cpc::sum_parts(sc.db1_part, db1, p.hid_tiles, F, K, stream);
  return (int)err;
}

}  // namespace

bool shapes_ok(int D, int F, int dtype) {
  const int chunk = dtype == cpc::kBFloat16 ? 64 : 32;
  return (dtype == cpc::kBFloat16 || dtype == cpc::kFloat32) && D >= 8 &&
         D % 8 == 0 && F > 0 && F % chunk == 0;
}

int row_tiles(int M, int D) {
  constexpr int kBM[cpc::kTailClasses + 1] = {
      TileRow<256>::BM, TileRow<512>::BM, TileRow<1024>::BM, kWideRows};
  const int bm = kBM[cpc::tail_width_class(D)];
  return (M + bm - 1) / bm;
}

size_t smem_bytes(int D) {
  constexpr size_t kSmem[cpc::kTailClasses + 1] = {
      smem_for<256>(), smem_for<512>(), smem_for<1024>(),
      cmax(cmax(ring<TileHid, false, false>(), ring<TileHid, false, true>()),
           ring<TileW, true, false>())};
  return kSmem[cpc::tail_width_class(D)];
}

size_t scratch_bytes(int K, int M, int D, int F, int dtype, bool fwd) {
  return dtype == cpc::kFloat32
             ? Scratch<float>(nullptr, K, M, D, F, fwd).bytes
             : Scratch<bf16>(nullptr, K, M, D, F, fwd).bytes;
}

int launch_fwd(const void* x, const float* ln1w, const float* ln1b,
               const void* w1, const float* b1, const void* w2,
               const float* b2, const float* ln2w, const float* ln2b,
               void* out, void* scratch, int K, int M, int D, int F,
               float eps, cpc::Dropout drop, int dtype, cudaStream_t stream) {
  if (dtype == cpc::kFloat32)
    return launch_fwd_body<float>(x, ln1w, ln1b, w1, b1, w2, b2, ln2w, ln2b,
                                  out, scratch, K, M, D, F, eps, drop,
                                  stream);
  return launch_fwd_body<bf16>(x, ln1w, ln1b, w1, b1, w2, b2, ln2w, ln2b,
                               out, scratch, K, M, D, F, eps, drop, stream);
}

int launch_bwd(const void* x, const float* ln1w, const float* ln1b,
               const void* w1, const float* b1, const void* w2,
               const float* b2, const float* ln2w, const float* ln2b,
               const void* dout, void* dx, float* vec_part, float* vec_out,
               float* dw1, float* db1, float* dw2, void* scratch, int K,
               int M, int D, int F, float eps, cpc::Dropout drop, int dtype,
               cudaStream_t stream) {
  if (dtype == cpc::kFloat32)
    return launch_bwd_body<float>(x, ln1w, ln1b, w1, b1, w2, b2, ln2w, ln2b,
                                  dout, dx, vec_part, vec_out, dw1, db1, dw2,
                                  scratch, K, M, D, F, eps, drop, stream);
  return launch_bwd_body<bf16>(x, ln1w, ln1b, w1, b1, w2, b2, ln2w, ln2b,
                               dout, dx, vec_part, vec_out, dw1, db1, dw2,
                               scratch, K, M, D, F, eps, drop, stream);
}

}  // namespace tail_tc
}  // namespace cpc
