// Particle-navigation rollout costs for every (parameter draw, action
// sample, policy) trajectory of one MultiDisco step (K6), and a probe of
// the particle kernels' occupancy test.
//
// Replaces the TPU kernel `fused_particle_rollout_costs`
// (dust_tpu/ops/pallas_particle_rollout.py, `_rollout_kernel`).
//
// Per trajectory: H Euler steps of the acceleration-control point mass
// with the occupancy of the current state shared by the cost
// (w_obs * occ) and the crash freeze (dt * (1 - occ)), the running cost
// of (s_t, a_t) summed, the terminal cost of s_H added after the loop
// (particle.cuh).
//
// Bound on this card: at the main-path shapes (4 x 64 x 6 trajectories,
// H = 40) the kernel reads 123 KB of actions and writes 6 KB of costs,
// and does ~8 M float32 operations (chip_smoke.py:_k6_bound): well under
// a microsecond of either; launch latency and the 40-step dependent chain
// of each thread bound it.
// Design: one thread per trajectory with its state in registers. The
// wrapper lays the actions out as [H, 2, trajectories], so neighbouring
// threads read neighbouring addresses at each horizon step; the model and
// the map's occupancy, one bit per cell (6 KB for the demo map), sit in
// shared memory, so the occupancy test is one lookup. The arithmetic
// follows the plain PyTorch version operation by operation (--fmad=false).

#include <cuda_runtime.h>

#include "particle.cuh"

namespace {

using namespace dust_particle;

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) particle_rollout_costs_kernel(
    const float* __restrict__ model, const float* __restrict__ state0,
    const float* __restrict__ acts, const float* __restrict__ masses,
    float* __restrict__ costs, int n_params, int n_traj, int hz) {
  __shared__ float km[kModelFloats];
  load_model(model, km);
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_params * n_traj) return;
  const int p = idx / n_traj;          // parameter draw
  const int traj = idx - p * n_traj;   // (action sample, policy) pair
  const float im = 1.0f / masses[p];
  float px = state0[0], py = state0[1], vx = state0[2], vy = state0[3];
  float cost = 0.0f;
  for (int t = 0; t < hz; ++t) {
    const float ax = acts[(2 * t) * n_traj + traj];
    const float ay = acts[(2 * t + 1) * n_traj + traj];
    cost = cost + step(km, px, py, vx, vy, ax, ay, im);
  }
  costs[idx] = cost + terminal_cost(km, px, py, vx, vy);
}

__global__ void __launch_bounds__(kThreads) particle_occupancy_kernel(
    const float* __restrict__ model, const float* __restrict__ pts,
    float* __restrict__ out, int n) {
  __shared__ float km[kModelFloats];
  load_model(model, km);
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < n) out[idx] = occupancy(km, pts[2 * idx], pts[2 * idx + 1]);
}

}  // namespace

// model: ops/particle_rollout.py:model_tensor; state0 [4]; acts
// [hz, 2, n_traj] (n_traj = n_act * n_pol); masses [n_params] -> costs
// [n_params, n_traj]. All device pointers, float32, contiguous.
extern "C" int dust_particle_rollout_costs(const float* model,
                                           const float* state0,
                                           const float* acts,
                                           const float* masses, float* costs,
                                           int n_params, int n_traj, int hz,
                                           void* stream) {
  const int n = n_params * n_traj;
  particle_rollout_costs_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      model, state0, acts, masses, costs, n_params, n_traj, hz);
  return static_cast<int>(cudaGetLastError());
}

// The occupancy (1.0 / 0.0) of n world points pts [n, 2] as the particle
// kernels compute it; a check of the device code, not a kernel of a path.
extern "C" int dust_particle_occupancy(const float* model, const float* pts,
                                       float* out, int n, void* stream) {
  particle_occupancy_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      model, pts, out, n);
  return static_cast<int>(cudaGetLastError());
}
