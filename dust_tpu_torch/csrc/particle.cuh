// Device code of the particle-navigation task shared by its kernels: the
// rollout costs (K6, particle_rollout.cu), the whole solve (K8,
// particle_solve.cu) and the whole episode (K9/K10, particle_episode.cu).
//
// The model (cost weights, target, dt and limits, the map's grid and its
// occupancy as one bit per cell) arrives as one float array laid out as
// ops/particle_rollout.py:model_tensor writes it; each block copies it to
// shared memory once (6 KB of bits for the demo's 220 x 220 cells;
// load_model, or load_model_async beside other copies). The
// occupancy of a world point is
//   xi = clip(floor(px * inv_cell + offx), 0, ximax)   (same for y)
//   occupied = bit xi * (yimax + 1) + yi,
// the bits set from the map's disjoint occupied rectangles, so the test
// equals ops/particle_rollout.py:occupancy_hit cell for cell on the
// clamped domain (chip_smoke.py checks every cell). The library is built
// with --fmad=false, so `px * inv_cell + offx` rounds twice, as the plain
// version does, and the floor never lands on the other side of a cell
// edge; there is no fast-math and no flush-to-zero.
//
// One Euler step of a trajectory computes the occupancy of the current
// state once and shares it between the running cost (w_obs * occ) and the
// crash-freeze factor dt * (1 - occ), which scales both the position and
// the velocity update; the position advances with the old velocity; then
// the velocity is clamped (NaN-propagating, as torch.clamp). The
// arithmetic follows ops/particle_rollout.py:rollout_costs operation by
// operation.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "stein.cuh"

namespace dust_particle {

using dust_solve::clampf;

// offsets into the model array
enum : int {
  kWpx = 0, kWpy, kWvx, kWvy,      // running state-cost weights
  kWcx, kWcy,                      // control-cost weights
  kWobs,                           // obstacle cost
  kWtPx, kWtPy, kWtVx, kWtVy,      // terminal state-cost weights
  kTx, kTy, kTvx, kTvy,            // target
  kDt, kMaxAcc, kMaxSpeed,
  kInvCell, kOffX, kOffY, kXiMax, kYiMax,
  kCrash, kHasMap, kNWords,
  kHeader                          // the occupancy bits (uint32 words)
};
constexpr int kMaxWords = 2048;    // 65,536 cells
constexpr int kModelFloats = kHeader + kMaxWords;

// Copy the model array into shared memory km[kModelFloats], the bit
// words as integers. Every thread of the block calls it (it synchronises
// the block).
__device__ inline void load_model(const float* src, float* km) {
  const int n = kHeader + static_cast<int>(src[kNWords]);
  const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
  uint32_t* d = reinterpret_cast<uint32_t*>(km);
#pragma unroll 8
  for (int e = threadIdx.x; e < n; e += blockDim.x) d[e] = s[e];
  __syncthreads();
}

// Start copying the model array's n floats into shared memory km (16 bytes
// at a time where both are aligned) without waiting: the caller commits
// and waits (cp_async.cuh), then passes a block barrier, once every copy
// it needs is in flight. The bit words travel as their bytes.
__device__ inline void load_model_async(const float* src, int n, float* km) {
  const bool vec = ((reinterpret_cast<uintptr_t>(src) |
                     reinterpret_cast<uintptr_t>(km)) & 15) == 0;
  const int n4 = vec ? n / 4 : 0;
  for (int q = threadIdx.x; q < n4; q += blockDim.x)
    dust_async::cp_async16(km + 4 * q, src + 4 * q);
  for (int e = 4 * n4 + threadIdx.x; e < n; e += blockDim.x)
    dust_async::cp_async4(km + e, src + e);
}

// 1.0 inside an obstacle cell, else 0.0 (0.0 without a map, and for a NaN
// position, whose comparisons all fail in the plain version).
__device__ __forceinline__ float occupancy(const float* km, float px,
                                           float py) {
  if (km[kHasMap] == 0.0f) return 0.0f;
  const float xi =
      clampf(floorf(px * km[kInvCell] + km[kOffX]), 0.0f, km[kXiMax]);
  const float yi =
      clampf(floorf(py * km[kInvCell] + km[kOffY]), 0.0f, km[kYiMax]);
  if (xi != xi || yi != yi) return 0.0f;
  const int cell = static_cast<int>(xi) * (static_cast<int>(km[kYiMax]) + 1) +
                   static_cast<int>(yi);
  const uint32_t word =
      reinterpret_cast<const uint32_t*>(km)[kHeader + (cell >> 5)];
  return ((word >> (cell & 31)) & 1u) ? 1.0f : 0.0f;
}

// w[0] (px - tx)^2 + w[1] (py - ty)^2 + w[2] (vx - tvx)^2
// + w[3] (vy - tvy)^2, plus w_obs * occ with a map; w the running
// (km + kWpx) or terminal (km + kWtPx) weights.
__device__ __forceinline__ float state_cost(const float* km, const float* w,
                                            float px, float py, float vx,
                                            float vy, float occ) {
  const float dx = px - km[kTx];
  const float dy = py - km[kTy];
  const float dvx = vx - km[kTvx];
  const float dvy = vy - km[kTvy];
  float c = w[0] * (dx * dx);
  c = c + w[1] * (dy * dy);
  c = c + w[2] * (dvx * dvx);
  c = c + w[3] * (dvy * dvy);
  if (km[kHasMap] != 0.0f) c = c + km[kWobs] * occ;
  return c;
}

// One Euler step of one trajectory under action (ax, ay) with 1/mass im;
// returns the running cost of (s_t, a_t).
__device__ __forceinline__ float step(const float* km, float& px, float& py,
                                      float& vx, float& vy, float ax,
                                      float ay, float im) {
  const float occ = occupancy(km, px, py);
  float c = state_cost(km, km + kWpx, px, py, vx, vy, occ);
  c = c + km[kWcx] * ax * ax;
  c = c + km[kWcy] * ay * ay;
  const float ma = km[kMaxAcc];
  const float ms = km[kMaxSpeed];
  const float acc_x = clampf(ax * im, -ma, ma);
  const float acc_y = clampf(ay * im, -ma, ma);
  const float scale =
      km[kCrash] != 0.0f ? km[kDt] * (1.0f - occ) : km[kDt];
  px = px + vx * scale;  // the old velocity
  py = py + vy * scale;
  vx = clampf(vx + acc_x * scale, -ms, ms);
  vy = clampf(vy + acc_y * scale, -ms, ms);
  return c;
}

// The terminal cost of s_H.
__device__ __forceinline__ float terminal_cost(const float* km, float px,
                                               float py, float vx,
                                               float vy) {
  return state_cost(km, km + kWtPx, px, py, vx, vy, occupancy(km, px, py));
}

// The navigation cost of one trajectory of one mass draw (1/mass im)
// from (px, py, vx, vy): the running costs in step order, then the
// terminal cost (ops/particle_rollout.py:rollout_costs for one draw).
// ld(t) returns the raw values behind step t's action, act(t, raw, ax, ay)
// makes the action from them; ld is called one step ahead of the chain,
// so a read's latency overlaps a step. K6, K8 and K9/K10 give each
// thread one trajectory (K8 and K9/K10 then add each pair's draws in draw
// order, stein.cuh:sum_draws).
template <class Load, class Act>
__device__ __forceinline__ float trajectory_cost(const float* km, float px,
                                                 float py, float vx,
                                                 float vy, float im, int hz,
                                                 Load ld, Act act) {
  float cost = 0.0f;
  float2 raw = ld(0);
  for (int t = 0; t < hz; ++t) {
    float ax, ay;
    act(t, raw, ax, ay);
    if (t + 1 < hz) raw = ld(t + 1);
    cost = cost + step(km, px, py, vx, vy, ax, ay, im);
  }
  return cost + terminal_cost(km, px, py, vx, vy);
}

}  // namespace dust_particle
