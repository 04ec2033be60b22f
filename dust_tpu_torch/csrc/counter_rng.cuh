// The counter-based noise of the whole-episode kernels (K4/K5 in
// pendulum_episode.cu, K9 in particle_episode.cu): lowbias32 hashes keyed
// by (seed0, seed1, step, scenario) and the draw index, uniforms from 23
// mantissa bits, Box-Muller normals. ops/episode.py (rng_key,
// counter_bits, bits_to_uniform, _normals_at) reproduces the same bits.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace dust_rng {

__device__ __forceinline__ uint32_t hash32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t rng_key(uint32_t s0, uint32_t s1,
                                            uint32_t step, uint32_t sc) {
  uint32_t k = hash32(s0 + 0x9e3779b9u);
  k = hash32(k ^ s1);
  k = hash32(k ^ step);
  return hash32(k ^ sc);
}

__device__ __forceinline__ float uniform_at(uint32_t key, uint32_t idx) {
  const uint32_t bits = hash32(hash32(idx ^ key) + key);
  return __uint_as_float((bits >> 9) | 0x3f800000u) - 1.0f;
}

__device__ __forceinline__ float normal_at(uint32_t key, uint32_t n) {
  const float u1 = uniform_at(key, 2u * n) + 5.9604644775390625e-08f;
  const float u2 = uniform_at(key, 2u * n + 1u);
  return sqrtf(-2.0f * logf(u1)) * cosf(6.2831855f * u2);
}

}  // namespace dust_rng
