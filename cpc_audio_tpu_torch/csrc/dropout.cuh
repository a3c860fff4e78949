// Counter-based dropout bits for the kernels, bit-identical to
// cpc_audio_tpu_torch/ops/dropout.py (see there for the index words of
// each site).  bits = fmix(mix(w2, mix(w1, mix(seed, site)))), where mix
// is the Feistel round function of ops/feistel.py and fmix murmur3's
// finaliser; an element is kept when bits >= threshold.  The words are
// absolute indices, so any tiling of a forward or backward pass draws the
// same mask.
#pragma once

#include <cstdint>

namespace cpc {

enum DropoutSite : uint32_t {
  kSiteAttention = 1,
  kSiteFFN = 2,
  kSiteARAttention = 6,
};

__device__ __forceinline__ uint32_t mix32(uint32_t x, uint32_t k) {
  uint32_t h = (x ^ k) * 0x9E3779B1u;
  h ^= h >> 15;
  h *= 0x85EBCA6Bu;
  return h ^ (h >> 13);
}

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

// The per-(site, w1) part of the hash, shared by a row of elements.
__device__ __forceinline__ uint32_t dropout_row_key(uint32_t seed,
                                                    uint32_t site,
                                                    uint32_t w1) {
  return mix32(w1, mix32(seed, site));
}

// Dropout factor of one element: 0 or 1 / (1 - rate).
__device__ __forceinline__ float dropout_factor(uint32_t row_key,
                                                uint32_t w2,
                                                uint32_t threshold,
                                                float keep_scale) {
  return fmix32(mix32(w2, row_key)) >= threshold ? keep_scale : 0.0f;
}

// Dropout parameters as a kernel receives them.  `seed` points at one
// int64 in device memory (null when rate == 0, where every factor is 1).
struct Dropout {
  const int64_t* seed;
  uint32_t threshold;
  float keep_scale;

  __device__ __forceinline__ bool active() const { return seed != nullptr; }
  __device__ __forceinline__ uint32_t seed_word() const {
    return static_cast<uint32_t>(*seed);
  }
};

}  // namespace cpc
