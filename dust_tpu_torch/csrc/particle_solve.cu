// One whole particle-navigation SVMPC solve in one launch (K8).
//
// Replaces the TPU kernel `fused_particle_solve`
// (dust_tpu/ops/pallas_solve.py, `_particle_solve_kernel` and
// `_solve_tail` with dim_a 2).
//
// One solve: all n_params x m x n_act point-mass rollouts with obstacle
// collisions (particle.cuh, K6's step) -> param-averaged costs -> DISCO
// softmax weights, a_mat / a_mix update -> likelihood gradient, GMM prior
// score with the weighted mixture's log-weights, RBF Stein step, SGD ->
// posterior weights, first-argmax selection, "repeat" roll by one step
// (two values) -> outputs. Noise, mass draws and the Silverman bandwidth
// are inputs. The particles are rows of hz * 2 values (the horizon
// flattened), so the softmaxes and the Stein step are K3's device code
// (stein.cuh).
//
// Bound on this card: at the main-path shapes (4 x 6 x 64 rollouts,
// H = 40, m = 6) the kernel moves ~137 KB (the actions 123 KB of it) and
// does ~8 M float32 operations (chip_smoke.py:_k8_bound): well under a
// microsecond of either. It is
// bound by the latency of its dependent phases (a 40-step rollout chain,
// then a dozen short reductions separated by block barriers).
// Design: one block of 256 threads per solve. Each thread owns one
// (particle, action sample) pair and carries the states of all n_params
// draws in registers; the model, particles, costs and softmax weights
// live in shared memory; one warp per particle takes each softmax over the
// action samples.

#include <cuda_runtime.h>

#include "particle.cuh"
#include "stein.cuh"

namespace {

using namespace dust_solve;
using dust_particle::kModelFloats;

__host__ __device__ inline size_t solve_smem_floats(int m, int ev,
                                                    int n_act) {
  return kModelFloats + 4 * static_cast<size_t>(m) * ev +
         3 * static_cast<size_t>(m) * n_act + 3 * kMaxM * kMaxM +
         5 * kMaxM + kMaxParams + 4 + 2 * kWarps + 8 + 1;
}

__global__ void __launch_bounds__(kThreads) particle_solve_kernel(
    const float* __restrict__ model, const float* __restrict__ scal,
    const float* __restrict__ theta_in, const float* __restrict__ locs_in,
    const float* __restrict__ log_mix, const float* __restrict__ amat,
    const float* __restrict__ aseq, const float* __restrict__ actions,
    const float* __restrict__ masses, float* __restrict__ theta_opt,
    float* __restrict__ theta_fwd, float* __restrict__ amat_out,
    float* __restrict__ a_mix, float* __restrict__ aseq_sel,
    float* __restrict__ weights, float* __restrict__ costs, int hz, int m,
    int n_params, int n_act, float log_n_act, int exp_util) {
  extern __shared__ float sh[];
  const int ev = 2 * hz;
  const int mh = m * ev;
  const int ma = m * n_act;
  float* km = sh;
  float* theta = km + kModelFloats;
  float* locs = theta + mh;
  float* score = locs + mh;
  float* theta_new = score + mh;
  float* mcost = theta_new + mh;
  float* omega = mcost + ma;
  float* w_lik = omega + ma;
  SteinSmem ss;
  ss.lp = w_lik + ma;
  ss.r = ss.lp + kMaxM * kMaxM;
  ss.kmat = ss.r + kMaxM * kMaxM;
  ss.rowsum = ss.kmat + kMaxM * kMaxM;
  ss.log_w = ss.rowsum + kMaxM;
  ss.weights = ss.log_w + kMaxM;
  float* eta = ss.weights + kMaxM;
  float* log_l = eta + kMaxM;
  float* im = log_l + kMaxM;
  float* s0 = im + kMaxParams;
  float* red = s0 + 4;  // 2 * kWarps + 8
  ss.i_star = reinterpret_cast<int*>(red + 2 * kWarps + 8);

  const int tid = threadIdx.x;
  // scal: [x, y, vx, vy, bw, lr, alpha, inv_temp, inv_s2, inv_ps2]
  const float bw = scal[4], lr = scal[5], inv_s2 = scal[8];
  const float inv_ps2 = scal[9];
  const DiscoConsts dk{scal[7], scal[6], log_n_act,
                       static_cast<float>(1.0 / n_act), exp_util};
  for (int e = tid; e < mh; e += blockDim.x) {
    theta[e] = theta_in[e];
    locs[e] = locs_in[e];
  }
  if (tid < n_params) im[tid] = 1.0f / masses[tid];
  if (tid < 4) s0[tid] = scal[tid];
  dust_particle::load_model(model, km);  // synchronises the block

  // actions [n_act, m, hz, 2]
  auto act = [&](int q, int i, int t, int c) {
    return actions[((i * m + q) * hz + t) * 2 + c];
  };
  dust_particle::rollout_mcost(km, s0, im, n_params, m, hz, n_act, act,
                               mcost);
  __syncthreads();
  for (int e = tid; e < ma; e += blockDim.x) {
    const int q = e / n_act;
    costs[(e - q * n_act) * m + q] = mcost[e];  // [n_act, m]
  }
  disco_weights(mcost, m, n_act, dk, omega, w_lik, eta, log_l, red);

  // delta_q = sum_i omega[q, i] (a[i, q, :] - a_seq); the likelihood
  // gradient (sum_i w[q, i] a[i, q, :] - theta_q) / sigma^2
  for (int e = tid; e < mh; e += blockDim.x) {
    const int q = e / ev;
    const int l = e - q * ev;
    float d = 0.0f, wa = 0.0f;
    for (int i = 0; i < n_act; ++i) {
      const float a = actions[(i * m + q) * ev + l];
      d = d + omega[q * n_act + i] * (a - aseq[l]);
      wa = wa + w_lik[q * n_act + i] * a;
    }
    amat_out[e] = amat[e] + d;
    score[e] = (wa - theta[e]) * inv_s2;
  }
  if (tid == 0) {
    float emax = -INFINITY;
    for (int q = 0; q < m; ++q) emax = maxp(emax, eta[q]);
    float se = 0.0f;
    for (int q = 0; q < m; ++q) se = se + expf(eta[q] - emax);
    for (int q = 0; q < m; ++q) a_mix[q] = expf(eta[q] - emax) / se;
  }
  __syncthreads();

  stein_forward(theta, locs, score, log_mix, 1, log_l, m, ev, bw, lr,
                inv_ps2, ss, theta_new);
  const int star = *ss.i_star;
  for (int e = tid; e < mh; e += blockDim.x) {
    const int l = e % ev;
    theta_opt[e] = theta_new[e];
    // "repeat" roll by one step of two values; the last step repeats
    theta_fwd[e] = l < ev - 2 ? theta_new[e + 2] : theta_new[e];
  }
  for (int l = tid; l < ev; l += blockDim.x)
    aseq_sel[l] = star < m ? theta_new[star * ev + l] : 0.0f;
  if (tid < m) weights[tid] = ss.weights[tid];
}

}  // namespace

// model: ops/particle_rollout.py:model_tensor; scal [10]: x, y, vx, vy,
// bw, lr, alpha, inv_temp, inv_s2, inv_ps2. theta/locs/amat/theta_opt/
// theta_fwd/amat_out [m, hz, 2]; log_mix, a_mix, weights [m]; aseq,
// aseq_sel [hz, 2]; actions [n_act, m, hz, 2]; masses [n_params]; costs
// [n_act, m]. All device pointers, float32, contiguous; m <= 8,
// n_params <= 8. log_n_act = log(n_act), folded by the caller.
extern "C" int dust_particle_solve(
    const float* model, const float* scal, const float* theta,
    const float* locs, const float* log_mix, const float* amat,
    const float* aseq, const float* actions, const float* masses,
    float* theta_opt, float* theta_fwd, float* amat_out, float* a_mix,
    float* aseq_sel, float* weights, float* costs, int hz, int m,
    int n_params, int n_act, float log_n_act, int exp_util, void* stream) {
  if (m < 1 || m > kMaxM || n_params < 1 || n_params > kMaxParams ||
      hz < 1 || n_act < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = solve_smem_floats(m, 2 * hz, n_act) * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        particle_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  particle_solve_kernel<<<1, kThreads, bytes,
                          static_cast<cudaStream_t>(stream)>>>(
      model, scal, theta, locs, log_mix, amat, aseq, actions, masses,
      theta_opt, theta_fwd, amat_out, a_mix, aseq_sel, weights, costs, hz, m,
      n_params, n_act, log_n_act, exp_util);
  return static_cast<int>(cudaGetLastError());
}
