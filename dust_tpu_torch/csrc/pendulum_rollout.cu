// Pendulum rollout costs for every (parameter draw, action sample, policy)
// trajectory of one MultiDisco step (K1), and their mean over the draws.
//
// Replaces the TPU kernel `fused_pendulum_rollout_costs`
// (dust_tpu/ops/pallas_rollout.py, `_rollout_kernel`) and the draw mean
// of `make_fused_pendulum_state_costs`.
//
// Physics and cost, per trajectory: torque clamp +-2, Euler step of
// theta_dot, speed clamp +-8, theta advanced with the new theta_dot; cost
// sum_{t<H} 50 (cos th_t - 1)^2 + om_t^2 plus the same term at s_H.
//
// Bound on this card: at the main-path shapes (8 x 128 x 3 trajectories,
// H = 30) the kernel reads ~46 KB of actions and writes ~12 KB of costs
// (or 1.5 KB of draw means), and does ~1.8 MFLOP: well under a
// microsecond of either; the 30-step dependent chain of each trajectory
// (sinf feeds theta_dot, which feeds theta) bounds it.
// Design: a block per kTraj = 16 trajectories (a contiguous range of rows
// of the actions [n_act * n_pol, H]) and a group of 16 lanes per
// parameter draw over them (draws beyond kMaxDraws loop in the same
// block), one trajectory per thread with its state in registers: 24
// blocks of four warps at the demo's shapes, one warp per scheduler (32
// trajectories per block measured 7% slower, 8 the same). The block stages
// its trajectories' actions once for all its draws with one round of
// cp.async (rows padded to H + 1 floats, so the reads at one step fall in
// distinct banks); above kMaxStagedHz the threads read them from device
// memory instead. Each draw's length and mass are read through a stride
// (while the copies fly), or are a value passed as an argument (the
// model's default), so the caller makes no copy and no filled tensor; the
// draw mean is one shared-memory pass in draw order, then a product with
// 1 / n_params (as torch's mean scales its sum), so one MultiDisco hook
// call is this one launch. The arithmetic is the plain PyTorch version's
// operation by operation (--fmad=false, sinf/cosf at full precision), so
// the costs are bit-equal to it.

#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "phase_clock.cuh"

namespace {

constexpr float kMaxSpeed = 8.0f;
constexpr float kMaxTorque = 2.0f;
constexpr float kSwingupW = 50.0f;
constexpr float kPi = 3.14159265358979323846f;
// trajectories per block (ops/rollout.py:TRAJ_PER_BLOCK): two draws per
// warp
constexpr int kTraj = 16;
// parameter draws per block at a time (kTraj lanes each); more loop
constexpr int kMaxDraws = 8;
// the longest horizon whose actions a block stages in shared memory
// (ops/rollout.py:MAX_STAGED_HORIZON; 16 rows of 257 floats, 16.4 KB)
constexpr int kMaxStagedHz = 256;

// The phases of K1 that its clocked build times
// (ops/rollout.py:CLOCK_PHASES, phase_clock.cuh); a launch with more than
// kMaxDraws draws adds each round's rollouts and store to its phase.
enum : int { kClkLoad = 0, kClkRollouts, kClkStore, kClkPhases };

// One draw column: ptr[p * stride] where ptr is not null, else value.
struct Column {
  const float* ptr;
  long long stride;
  float value;

  __device__ __forceinline__ float at(int p) const {
    return ptr != nullptr ? __ldg(ptr + p * stride) : value;
  }
};

__device__ __forceinline__ float swingup_cost(float th, float om) {
  const float c = cosf(th) - 1.0f;
  return kSwingupW * (c * c) + om * om;
}

// One trajectory's cost; act(t) is its action at step t. Each step
// computes the next state, then adds the cost of the current one, and the
// loop is unrolled by 2: 5-10% faster than the plain version's order
// without unrolling (chip_compare.py on an NVIDIA H100 80GB HBM3 at 700 W).
// The operations and their operands are the plain version's, so are the
// bits. What is left, ~260 cycles a step, is sinf's and cosf's range
// reductions, each closed by a branch to its slow path, one after the
// other.
template <class Act>
__device__ __forceinline__ float trajectory_cost(float th, float om,
                                                 float c_grav, float c_act,
                                                 float dt, int hz, Act act) {
  float cost = 0.0f;
#pragma unroll 2
  for (int t = 0; t < hz; ++t) {
    const float at = fminf(fmaxf(act(t), -kMaxTorque), kMaxTorque);
    float om_n = om + c_grav * sinf(th + kPi) + c_act * at;
    om_n = fminf(fmaxf(om_n, -kMaxSpeed), kMaxSpeed);
    const float th_n = th + om_n * dt;            // new theta_dot
    cost = cost + swingup_cost(th, om);           // charges s_0 .. s_{H-1}
    th = th_n;
    om = om_n;
  }
  return cost + swingup_cost(th, om);             // terminal s_H
}

template <bool kStaged, bool kClock>
__global__ void __launch_bounds__(kTraj * kMaxDraws)
pendulum_rollout_costs_kernel(const float* __restrict__ state0,
                              const float* __restrict__ actions,
                              const Column lengths, const Column masses,
                              float* __restrict__ costs,
                              float* __restrict__ cost_mean, int n_params,
                              int n_traj, int hz, float c_grav0,
                              float c_act0, float dt,
                              long long* __restrict__ clock) {
  extern __shared__ __align__(16) float sa[];  // [kTraj, hz + 1] actions
  __shared__ float sc[kMaxDraws * kTraj];      // one round's costs
  __shared__ long long clk_acc[kClkPhases];
  dust_clock::PhaseClock<kClock, kClkPhases> clk(clk_acc);
  const int ast = hz + 1;
  const int t0 = blockIdx.x * kTraj;  // this block's first trajectory
  const int nb = min(kTraj, n_traj - t0);
  if constexpr (kStaged) {
    const float* src = actions + static_cast<size_t>(t0) * hz;
    for (int e = threadIdx.x; e < nb * hz; e += blockDim.x) {
      const int r = e / hz;
      dust_async::cp_async4(sa + r * ast + (e - r * hz), src + e);
    }
  }
  // this thread's trajectory and first draw, and what it reads from
  // device memory (the start state, the first draw's length and mass),
  // while the copies fly
  const int lane = threadIdx.x % kTraj;
  const int w = threadIdx.x / kTraj;
  const int draws = blockDim.x / kTraj;  // draws per round
  const bool active = lane < nb;
  const float th0 = __ldg(state0);
  const float om0 = __ldg(state0 + 1);
  float len = 1.0f, mass = 1.0f;
  if (active && w < n_params) {
    len = lengths.at(w);
    mass = masses.at(w);
  }
  if constexpr (kStaged) {
    dust_async::cp_async_commit();
    dust_async::cp_async_wait<0>();
    __syncthreads();
  }
  clk.mark(kClkLoad);

  float sum = 0.0f;  // the draws' running sum (draw 0's lanes)
  for (int p0 = 0; p0 < n_params; p0 += draws) {
    const int p = p0 + w;
    float cost = 0.0f;
    if (active && p < n_params) {
      if (p0 > 0) {
        len = lengths.at(p);
        mass = masses.at(p);
      }
      const float il = 1.0f / len;
      const float im = 1.0f / mass;
      const float c_grav = c_grav0 * il;          // dt * (-3g / 2l)
      const float c_act = c_act0 * im * il * il;  // dt * 3 / (m l^2)
      if constexpr (kStaged) {
        const float* ai = sa + lane * ast;
        cost = trajectory_cost(th0, om0, c_grav, c_act, dt, hz,
                               [&](int t) { return ai[t]; });
      } else {
        const float* ai = actions + static_cast<size_t>(t0 + lane) * hz;
        cost = trajectory_cost(th0, om0, c_grav, c_act, dt, hz,
                               [&](int t) { return __ldg(ai + t); });
      }
      if (costs != nullptr)
        costs[static_cast<size_t>(p) * n_traj + t0 + lane] = cost;
    }
    clk.mark(kClkRollouts);
    if (cost_mean != nullptr) {
      // the round's costs meet in shared memory; draw 0's lanes add
      // them in draw order
      sc[w * kTraj + lane] = cost;
      __syncthreads();
      if (w == 0) {
        const int nr = min(draws, n_params - p0);
        for (int q = 0; q < nr; ++q) sum = sum + sc[q * kTraj + lane];
      }
      __syncthreads();
    }
    clk.mark(kClkStore);
  }
  if (cost_mean != nullptr && w == 0 && active)
    cost_mean[t0 + lane] = sum * (1.0f / static_cast<float>(n_params));
  if constexpr (kClock) clk.write(clock + blockIdx.x * (kClkPhases + 2));
}

template <bool kStaged, bool kClock>
int launch_as(const float* state0, const float* actions, Column lengths,
              Column masses, float* costs, float* cost_mean, int n_params,
              int n_traj, int hz, float c_grav0, float c_act0, float dt,
              long long* clock, cudaStream_t stream) {
  const int blocks = (n_traj + kTraj - 1) / kTraj;
  const int threads = kTraj * min(n_params, kMaxDraws);
  const size_t shmem =
      kStaged ? static_cast<size_t>(kTraj) * (hz + 1) * sizeof(float) : 0;
  pendulum_rollout_costs_kernel<kStaged, kClock>
      <<<blocks, threads, shmem, stream>>>(
          state0, actions, lengths, masses, costs, cost_mean, n_params,
          n_traj, hz, c_grav0, c_act0, dt, clock);
  return static_cast<int>(cudaGetLastError());
}

template <bool kClock>
int launch(const float* state0, const float* actions, const float* len_ptr,
           long long len_stride, float len_value, const float* mass_ptr,
           long long mass_stride, float mass_value, float* costs,
           float* cost_mean, int n_params, int n_traj, int hz,
           float c_grav0, float c_act0, float dt, long long* clock,
           cudaStream_t stream) {
  if (n_params < 1 || n_traj < 1 || hz < 1 ||
      (costs == nullptr && cost_mean == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Column lengths{len_ptr, len_stride, len_value};
  const Column masses{mass_ptr, mass_stride, mass_value};
  return hz <= kMaxStagedHz
             ? launch_as<true, kClock>(state0, actions, lengths, masses,
                                       costs, cost_mean, n_params, n_traj,
                                       hz, c_grav0, c_act0, dt, clock, stream)
             : launch_as<false, kClock>(state0, actions, lengths, masses,
                                        costs, cost_mean, n_params, n_traj,
                                        hz, c_grav0, c_act0, dt, clock,
                                        stream);
}

}  // namespace

// state0 [2]; actions [n_traj, hz] (= [n_act, n_pol, hz, 1]), contiguous;
// the draws' lengths: len_ptr[p * len_stride], or len_value where len_ptr
// is null (masses likewise) -> costs [n_params, n_traj] and / or their
// mean over the draws cost_mean [n_traj] (either may be null, not both).
// Device pointers, float32. c_grav0 = -3 g 0.5 dt, c_act0 = 3 dt.
extern "C" int dust_pendulum_rollout_costs(
    const float* state0, const float* actions, const float* len_ptr,
    long long len_stride, float len_value, const float* mass_ptr,
    long long mass_stride, float mass_value, float* costs, float* cost_mean,
    int n_params, int n_traj, int hz, float c_grav0, float c_act0, float dt,
    void* stream) {
  return launch<false>(state0, actions, len_ptr, len_stride, len_value,
                       mass_ptr, mass_stride, mass_value, costs, cost_mean,
                       n_params, n_traj, hz, c_grav0, c_act0, dt, nullptr,
                       static_cast<cudaStream_t>(stream));
}

// dust_pendulum_rollout_costs's clocked build: clock [blocks, kClkPhases
// + 2] int64 receives each block's phases' cycles (load, rollouts, store;
// a measurement aid, the results are the same).
extern "C" int dust_pendulum_rollout_costs_clock(
    const float* state0, const float* actions, const float* len_ptr,
    long long len_stride, float len_value, const float* mass_ptr,
    long long mass_stride, float mass_value, float* costs, float* cost_mean,
    int n_params, int n_traj, int hz, float c_grav0, float c_act0, float dt,
    long long* clock, void* stream) {
  return launch<true>(state0, actions, len_ptr, len_stride, len_value,
                      mass_ptr, mass_stride, mass_value, costs, cost_mean,
                      n_params, n_traj, hz, c_grav0, c_act0, dt, clock,
                      static_cast<cudaStream_t>(stream));
}
