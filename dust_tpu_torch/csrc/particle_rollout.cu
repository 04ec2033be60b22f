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
// (particle.cuh:trajectory_cost, K8's and K9/K10's code, so the costs keep
// their bits).
//
// Bound on this card: at the main-path shapes (4 x 64 x 6 trajectories,
// H = 40) the kernel reads 123 KB of actions and writes 6 KB of costs,
// and does ~8 M float32 operations (chip_smoke.py:_k6_bound): well under
// a microsecond of either; the 40-step dependent chain of each
// trajectory and the loads before it bound it.
// Design: a block per kTraj = 32 trajectories (a contiguous range of rows
// of the actions in their native layout [n_act, n_pol, H, 2], so the
// wrapper launches no copy), a warp per mass draw over them (blockIdx.y
// takes draws beyond kMaxDraws), one trajectory per thread: 12 blocks of
// four warps at the demo's shapes, each warp on its own scheduler. The
// block stages the model (occupancy bits in shared memory, one lookup per
// test) and its trajectories' actions (rows padded to 2 H + 1 floats, so a
// warp's reads at one step fall in distinct banks) with cp.async, all
// copies in flight together, so the actions are read from device memory
// once for all the draws; each thread then reads its actions from shared
// memory one step ahead of the chain. The arithmetic follows the plain
// PyTorch version operation by operation (--fmad=false).

#include <cuda_runtime.h>

#include "particle.cuh"
#include "phase_clock.cuh"

namespace {

using namespace dust_particle;

// trajectories per block: the lanes of each warp
constexpr int kTraj = 32;
// mass draws per block (a warp each); more go to blockIdx.y
constexpr int kMaxDraws = 8;

// The phases of K6 that its clocked build times
// (ops/particle_rollout.py:CLOCK_PHASES, phase_clock.cuh).
enum : int { kClkLoad = 0, kClkRollouts, kClkStore, kClkPhases };

// Shared floats of a block: the model (rounded up to 16 bytes), then the
// actions of kTraj trajectories in rows of 2 hz + 1.
__host__ __device__ inline int model_floats(int n_model) {
  return (n_model + 3) & ~3;
}

template <bool kClock>
__global__ void __launch_bounds__(kTraj * kMaxDraws)
particle_rollout_costs_kernel(const float* __restrict__ model, int n_model,
                              const float* __restrict__ state0,
                              const float* __restrict__ acts,
                              const float* __restrict__ masses,
                              float* __restrict__ costs, int n_params,
                              int n_traj, int hz,
                              long long* __restrict__ clock) {
  extern __shared__ __align__(16) float sh[];
  __shared__ long long clk_acc[kClkPhases];
  dust_clock::PhaseClock<kClock, kClkPhases> clk(clk_acc);
  const int ev = 2 * hz;
  const int ast = ev + 1;
  float* km = sh;
  float* sa = sh + model_floats(n_model);  // [kTraj, ev + 1]
  const int t0 = blockIdx.x * kTraj;       // this block's first trajectory
  const int nb = min(kTraj, n_traj - t0);
  load_model_async(model, n_model, km);
  const float* src = acts + static_cast<size_t>(t0) * ev;
  for (int e = threadIdx.x; e < nb * ev; e += blockDim.x) {
    const int r = e / ev;
    dust_async::cp_async4(sa + r * ast + (e - r * ev), src + e);
  }
  // this thread's trajectory and draw, and what it reads from device
  // memory, while the copies fly
  const int lane = threadIdx.x % kTraj;
  const int p = blockIdx.y * kMaxDraws + threadIdx.x / kTraj;
  const bool active = lane < nb && p < n_params;
  float s0[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float im = 0.0f;
  if (active) {
    for (int c = 0; c < 4; ++c) s0[c] = __ldg(state0 + c);
    im = 1.0f / __ldg(masses + p);
  }
  dust_async::cp_async_commit();
  dust_async::cp_async_wait<0>();
  __syncthreads();
  clk.mark(kClkLoad);

  float cost = 0.0f;
  if (active) {
    const float* ai = sa + lane * ast;
    cost = trajectory_cost(
        km, s0[0], s0[1], s0[2], s0[3], im, hz,
        [&](int t) { return make_float2(ai[2 * t], ai[2 * t + 1]); },
        [&](int, float2 v, float& ax, float& ay) {
          ax = v.x;
          ay = v.y;
        });
  }
  clk.mark(kClkRollouts);
  if (active) costs[static_cast<size_t>(p) * n_traj + t0 + lane] = cost;
  clk.mark(kClkStore);
  if constexpr (kClock)
    clk.write(clock + (static_cast<size_t>(blockIdx.y) * gridDim.x +
                       blockIdx.x) * (kClkPhases + 2));
}

__global__ void __launch_bounds__(256) particle_occupancy_kernel(
    const float* __restrict__ model, const float* __restrict__ pts,
    float* __restrict__ out, int n) {
  __shared__ float km[kModelFloats];
  load_model(model, km);
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < n) out[idx] = occupancy(km, pts[2 * idx], pts[2 * idx + 1]);
}

template <bool kClock>
int launch(const float* model, int n_model, const float* state0,
           const float* acts, const float* masses, float* costs,
           int n_params, int n_traj, int hz, long long* clock,
           cudaStream_t stream) {
  if (n_params < 1 || n_traj < 1 || hz < 1 || n_model < kHeader ||
      n_model > kModelFloats)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n_traj + kTraj - 1) / kTraj,
                  (n_params + kMaxDraws - 1) / kMaxDraws);
  const int threads = kTraj * min(n_params, kMaxDraws);
  const size_t shmem =
      (static_cast<size_t>(model_floats(n_model)) +
       static_cast<size_t>(kTraj) * (2 * hz + 1)) * sizeof(float);
  if (shmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        particle_rollout_costs_kernel<kClock>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shmem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  particle_rollout_costs_kernel<kClock><<<grid, threads, shmem, stream>>>(
      model, n_model, state0, acts, masses, costs, n_params, n_traj, hz,
      clock);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// model: ops/particle_rollout.py:model_tensor, n_model floats; state0
// [4]; acts [n_act, n_pol, hz, 2] (n_traj = n_act * n_pol rows of 2 hz);
// masses [n_params] -> costs [n_params, n_traj]. All device pointers,
// float32, contiguous.
extern "C" int dust_particle_rollout_costs(const float* model, int n_model,
                                           const float* state0,
                                           const float* acts,
                                           const float* masses, float* costs,
                                           int n_params, int n_traj, int hz,
                                           void* stream) {
  return launch<false>(model, n_model, state0, acts, masses, costs, n_params,
                       n_traj, hz, nullptr,
                       static_cast<cudaStream_t>(stream));
}

// dust_particle_rollout_costs's clocked build: clock [blocks, kClkPhases +
// 2] int64 (blocks in blockIdx.y-major order) receives each block's
// phases' cycles (load, rollouts, store; a measurement aid, the costs are
// the same).
extern "C" int dust_particle_rollout_costs_clock(
    const float* model, int n_model, const float* state0, const float* acts,
    const float* masses, float* costs, int n_params, int n_traj, int hz,
    long long* clock, void* stream) {
  return launch<true>(model, n_model, state0, acts, masses, costs, n_params,
                      n_traj, hz, clock, static_cast<cudaStream_t>(stream));
}

// The occupancy (1.0 / 0.0) of n world points pts [n, 2] as the particle
// kernels compute it; a check of the device code, not a kernel of a path.
extern "C" int dust_particle_occupancy(const float* model, const float* pts,
                                       float* out, int n, void* stream) {
  particle_occupancy_kernel<<<(n + 255) / 256, 256, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      model, pts, out, n);
  return static_cast<int>(cudaGetLastError());
}
