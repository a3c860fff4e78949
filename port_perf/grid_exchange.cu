// The grid backward's exchange of partial carries alone, and the
// all-gather it was chosen over, for port_perf/grid_exchange.py: one
// cooperative launch of `ncta` CTAs (csrc/rnn_grid.cuh `launch`) runs
// `steps` steps of
//   0 "reduce-scatter" (what csrc/rnn_grid.cuh `bwd_kernel` does): each CTA
//     stores its partial carry, B x H float32 as (16-column, 8-row) tiles
//     in accumulator order (KS x NT tiles, a 16-byte store a lane), a grid
//     barrier, then each CTA sums its J units of B rows over every CTA's
//     tiles (float2 loads, groups of threads over runs of the sources, the
//     groups in order);
//   1 "all-gather": each CTA stores its own dgates, B x G J values of 4
//     bytes (a bf16 hi and lo pair), a grid barrier, then each CTA reads
//     every CTA's block (16-byte loads), as a product of all of dgates by
//     W_hh's columns would need;
//   2 "barrier": the grid barrier alone.
// A stored value is (step + source); each reader checks what it loads and
// counts the mismatches into bad[].
#include "../cpc_audio_tpu_torch/csrc/rnn_grid.cuh"

namespace grid = cpc::grid;

namespace {

constexpr int kThreads = grid::kThreads;

template <int MODE>
__global__ void __launch_bounds__(kThreads, 1)
    exchange_kernel(float* buf, unsigned* bar, int* bad, int steps, int B,
                    int H, int G, int J) {
  __shared__ float2 gp[kThreads];
  const int c = blockIdx.x, ncta = gridDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int KS = (H + 15) / 16, NT = (B + 7) / 8;
  const size_t per_src = (size_t)KS * NT * 128;     // floats
  int wrong = 0;
  for (int t = 0; t < steps; ++t) {
    const float v = (float)(t + c);
    if (MODE == 0) {
      float* out = buf + ((size_t)(t & 1) * ncta + c) * per_src;
      for (int tile = warp; tile < KS * NT; tile += grid::kWarps)
        *reinterpret_cast<float4*>(out + ((size_t)tile * 32 + lane) * 4) =
            make_float4(v, v, v, v);
    } else if (MODE == 1) {
      const int n4 = B * G * J / 4;                   // float4 a CTA
      float* out = buf + ((size_t)(t & 1) * ncta + c) * n4 * 4;
      for (int i = tid; i < n4; i += kThreads)
        *reinterpret_cast<float4*>(out + (size_t)i * 4) =
            make_float4(v, v, v, v);
    }
    grid::grid_sync(bar);
    if (MODE == 0) {
      const int BP = (B + 1) / 2, items = J * BP, S = kThreads / items;
      const int it = tid % items, grp = tid / items;
      const int j = it % J, b = 2 * (it / J), col = c * J + j;
      if (grp < S && col < H) {
        const int r = col & 15;
        const float* base =
            buf + (size_t)(t & 1) * ncta * per_src +
            (((size_t)(col >> 4) * NT + (b >> 3)) * 32 + 4 * (r & 7) +
             ((b & 7) >> 1)) * 4 + 2 * (r >> 3);
        float2 sum = make_float2(0.0f, 0.0f);
        const int s1 = (grp + 1) * ncta / S;
#pragma unroll 8
        for (int src = grp * ncta / S; src < s1; ++src) {
          const float2 x =
              __ldcg(reinterpret_cast<const float2*>(base + src * per_src));
          sum.x += x.x;
          sum.y += x.y;
        }
        gp[grp * items + it] = sum;
      }
      __syncthreads();
      if (tid < items && col < H) {
        float total = 0.0f;
        for (int g2 = 0; g2 < S; ++g2) total += gp[g2 * items + tid].x;
        // sum over the sources of (t + src)
        const float want = (float)ncta * t + 0.5f * ncta * (ncta - 1);
        wrong += total != want;
      }
      __syncthreads();
    } else if (MODE == 1) {
      const int n4 = B * G * J / 4;
      const float4* in =
          reinterpret_cast<const float4*>(buf + (size_t)(t & 1) * ncta * n4 *
                                                    4);
#pragma unroll 4
      for (int i = tid; i < ncta * n4; i += kThreads) {
        const float4 x = __ldcg(in + i);
        wrong += x.x != (float)(t + i / n4);
      }
    }
  }
  if (wrong) atomicAdd(bad, wrong);
}

}  // namespace

// Bytes of buffer a mode needs.
extern "C" size_t grid_exchange_bytes(int mode, int ncta, int B, int H,
                                      int G, int J) {
  const size_t KS = (H + 15) / 16, NT = (B + 7) / 8;
  if (mode == 0) return 2 * (size_t)ncta * KS * NT * 128 * sizeof(float);
  if (mode == 1) return 2 * (size_t)ncta * B * G * J * sizeof(float);
  return 16;
}

extern "C" int grid_exchange(int mode, int ncta, int steps, int B, int H,
                             int G, int J, void* buf, void* bar, void* bad,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* b = static_cast<float*>(buf);
  unsigned* w = static_cast<unsigned*>(bar);
  int* d = static_cast<int*>(bad);
  const size_t smem = 0;
  cudaError_t err =
      mode == 0 ? grid::launch(exchange_kernel<0>, ncta, smem, s, b, w, d,
                               steps, B, H, G, J)
      : mode == 1 ? grid::launch(exchange_kernel<1>, ncta, smem, s, b, w, d,
                                 steps, B, H, G, J)
                  : grid::launch(exchange_kernel<2>, ncta, smem, s, b, w, d,
                                 steps, B, H, G, J);
  return (int)err;
}
