// Pendulum rollout costs for every (parameter draw, action sample, policy)
// trajectory of one MultiDisco step.
//
// Replaces the TPU kernel `fused_pendulum_rollout_costs`
// (dust_tpu/ops/pallas_rollout.py, `_rollout_kernel`).
//
// Physics and cost, per trajectory: torque clamp +-2, Euler step of
// theta_dot, speed clamp +-8, theta advanced with the new theta_dot; cost
// sum_{t<H} 50 (cos th_t - 1)^2 + om_t^2 plus the same term at s_H.
//
// Bound on this card: at the main-path shapes (8 x 128 x 3 trajectories,
// H = 30) the kernel reads ~46 KB of actions and writes ~12 KB of costs,
// and does ~1.8 MFLOP: well under a microsecond of either, so launch
// latency and the 30-step dependent chain of each thread bound it.
// Design: one thread per trajectory with its state in registers, looping
// over the horizon; the action sequence is read once per trajectory and
// shared by the parameter draws (no 8x tiling as on the TPU, where lanes
// had to be filled); 1/length and 1/mass are read once per thread. The
// arithmetic follows the plain PyTorch version operation by operation
// (the library is built with --fmad=false, sinf/cosf at full precision).

#include <cuda_runtime.h>

namespace {

constexpr float kMaxSpeed = 8.0f;
constexpr float kMaxTorque = 2.0f;
constexpr float kSwingupW = 50.0f;
constexpr float kPi = 3.14159265358979323846f;
constexpr int kThreads = 128;

__device__ __forceinline__ float swingup_cost(float th, float om) {
  const float c = cosf(th) - 1.0f;
  return kSwingupW * (c * c) + om * om;
}

__global__ void __launch_bounds__(kThreads) pendulum_rollout_costs_kernel(
    const float* __restrict__ state0, const float* __restrict__ actions,
    const float* __restrict__ lengths, const float* __restrict__ masses,
    float* __restrict__ costs, int n_params, int n_traj, int hz,
    float c_grav0, float c_act0, float dt) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_params * n_traj) return;
  const int p = idx / n_traj;           // parameter draw
  const int traj = idx - p * n_traj;    // (action sample, policy) pair

  const float il = 1.0f / lengths[p];
  const float im = 1.0f / masses[p];
  const float c_grav = c_grav0 * il;              // dt * (-3g / 2l)
  const float c_act = c_act0 * im * il * il;      // dt * 3 / (m l^2)

  float th = state0[0];
  float om = state0[1];
  float cost = 0.0f;
  const float* a = actions + static_cast<size_t>(traj) * hz;
  for (int t = 0; t < hz; ++t) {
    cost = cost + swingup_cost(th, om);           // charges s_0 .. s_{H-1}
    const float at = fminf(fmaxf(a[t], -kMaxTorque), kMaxTorque);
    om = om + c_grav * sinf(th + kPi) + c_act * at;
    om = fminf(fmaxf(om, -kMaxSpeed), kMaxSpeed);
    th = th + om * dt;                            // new theta_dot
  }
  costs[idx] = cost + swingup_cost(th, om);       // terminal s_H
}

}  // namespace

// state0 [2]; actions [n_traj, hz] (= [n_act, n_pol, hz, 1]); lengths,
// masses [n_params] -> costs [n_params, n_traj]. All device pointers,
// float32, contiguous. c_grav0 = -3 g 0.5 dt, c_act0 = 3 dt.
extern "C" int dust_pendulum_rollout_costs(
    const float* state0, const float* actions, const float* lengths,
    const float* masses, float* costs, int n_params, int n_traj, int hz,
    float c_grav0, float c_act0, float dt, void* stream) {
  const int n = n_params * n_traj;
  const int blocks = (n + kThreads - 1) / kThreads;
  pendulum_rollout_costs_kernel<<<blocks, kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      state0, actions, lengths, masses, costs, n_params, n_traj, hz,
      c_grav0, c_act0, dt);
  return static_cast<int>(cudaGetLastError());
}
