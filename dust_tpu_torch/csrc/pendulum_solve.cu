// One whole pendulum SVMPC solve in one launch (K3).
//
// Replaces the TPU kernel `fused_pendulum_solve`
// (dust_tpu/ops/pallas_solve.py, `_pendulum_solve_kernel` and
// `_solve_tail`).
//
// One solve: all n_params x m x n_act rollouts (state (cos th, sin th, om)
// advanced by plane rotation) -> param-averaged costs -> DISCO softmax
// weights, a_mat / a_mix update -> likelihood gradient, GMM prior score,
// RBF Stein step, SGD -> posterior weights, first-argmax selection,
// "repeat" roll. Noise, parameter draws and the Silverman bandwidth are
// inputs.
//
// Bound on this card: at the main-path shapes (8 x 3 x 128 rollouts,
// H = 30, m = 3) the kernel moves ~50 KB (mostly the actions) and does
// ~3.3 M float32 operations (chip_smoke.py:_k3_bound): well under a
// microsecond of either. It is bound by the latency of its
// dependent phases (a 30-step rollout chain, then a dozen short
// reductions separated by block barriers).
// Design: one block of 256 threads per solve. Each thread owns one
// (particle, action sample) pair and carries the states of all n_params
// draws in registers, so the parameter draws are independent chains that
// hide each other's latency, and the param average needs no shared
// memory; costs, softmax weights and the particles live in shared memory
// (dust_solve:: in pendulum_solve.cuh and stein.cuh, shared with the
// episode kernels).
// One warp per particle takes each softmax over the action samples.

#include <cuda_runtime.h>

#include "pendulum_solve.cuh"

namespace {

using namespace dust_solve;

__global__ void __launch_bounds__(kThreads, 1) pendulum_solve_kernel(
    const float* __restrict__ scal, const float* __restrict__ theta_in,
    const float* __restrict__ locs_in, const float* __restrict__ log_mix,
    const float* __restrict__ amat, const float* __restrict__ aseq,
    const float* __restrict__ actions, const float* __restrict__ lengths,
    const float* __restrict__ masses, float* __restrict__ theta_opt,
    float* __restrict__ theta_fwd, float* __restrict__ amat_out,
    float* __restrict__ a_mix, float* __restrict__ aseq_sel,
    float* __restrict__ weights, float* __restrict__ costs, int hz, int m,
    int n_params, int n_act, RolloutConsts rk, float log_n_act,
    int exp_util) {
  extern __shared__ float sh[];
  const int mh = m * hz;
  const int ma = m * n_act;
  float* theta = sh;
  float* locs = theta + mh;
  float* score = locs + mh;
  float* theta_new = score + mh;
  float* mcost = theta_new + mh;
  float* omega = mcost + ma;
  float* w_lik = omega + ma;
  float* small = w_lik + ma;
  SteinSmem ss;
  ss.lp = small;
  ss.r = ss.lp + kMaxM * kMaxM;
  ss.kmat = ss.r + kMaxM * kMaxM;
  ss.rowsum = ss.kmat + kMaxM * kMaxM;
  ss.log_w = ss.rowsum + kMaxM;
  ss.weights = ss.log_w + kMaxM;
  float* eta = ss.weights + kMaxM;
  float* log_l = eta + kMaxM;
  float* il = log_l + kMaxM;
  float* im = il + kMaxParams;
  float* red = im + kMaxParams;  // 2 * kWarps + 8
  ss.i_star = reinterpret_cast<int*>(red + 2 * kWarps + 8);

  const int tid = threadIdx.x;
  // scal: [th0, om0, bw, lr, alpha, inv_temp, inv_s2, inv_ps2]
  const float th0 = scal[0], om0 = scal[1], bw = scal[2], lr = scal[3];
  const float inv_s2 = scal[6], inv_ps2 = scal[7];
  const DiscoConsts dk{scal[5], scal[4], log_n_act,
                       static_cast<float>(1.0 / n_act), exp_util};
  for (int e = tid; e < mh; e += blockDim.x) {
    theta[e] = theta_in[e];
    locs[e] = locs_in[e];
  }
  if (tid < n_params) {
    il[tid] = 1.0f / lengths[tid];
    im[tid] = 1.0f / masses[tid];
  }
  __syncthreads();

  // actions [n_act, m, hz], taken as they are
  auto act = [&](int q, int i, int t) {
    return actions[(i * m + q) * hz + t];
  };
  rollout_mcost(th0, om0, il, im, n_params, 0, ma, hz, n_act, rk, act,
                [](int, int, float raw) { return raw; }, mcost);
  __syncthreads();
  for (int e = tid; e < ma; e += blockDim.x) {
    const int q = e / n_act;
    costs[(e - q * n_act) * m + q] = mcost[e];  // [n_act, m]
  }
  disco_weights(mcost, m, n_act, dk, omega, w_lik, eta, log_l, red);

  // delta_q = sum_i omega[q, i] (a[i, q, :] - a_seq); the likelihood
  // gradient (sum_i w[q, i] a[i, q, :] - theta_q) / sigma^2
  for (int e = tid; e < mh; e += blockDim.x) {
    const int q = e / hz;
    const int t = e - q * hz;
    float d = 0.0f, wa = 0.0f;
    for (int i = 0; i < n_act; ++i) {
      const float a = act(q, i, t);
      d = d + omega[q * n_act + i] * (a - aseq[t]);
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

  stein_forward(theta, locs, score, log_mix, 1, log_l, m, hz, bw, lr,
                inv_ps2, ss, theta_new);
  const int star = *ss.i_star;
  for (int e = tid; e < mh; e += blockDim.x) {
    const int q = e / hz;
    const int t = e - q * hz;
    theta_opt[e] = theta_new[e];
    theta_fwd[e] = theta_new[q * hz + min(t + 1, hz - 1)];
  }
  for (int t = tid; t < hz; t += blockDim.x)
    aseq_sel[t] = star < m ? theta_new[star * hz + t] : 0.0f;
  if (tid < m) weights[tid] = ss.weights[tid];
}

}  // namespace

// scal [8]: th0, om0, bw, lr, alpha, inv_temp, inv_s2, inv_ps2.
// theta/locs/amat/theta_opt/theta_fwd/amat_out [m, hz]; log_mix, a_mix,
// weights [m]; aseq, aseq_sel [hz]; actions [n_act, m, hz];
// lengths/masses [n_params]; costs [n_act, m]. All device pointers,
// float32, contiguous; m <= 8, n_params <= 8. cg = -3 g 0.5 dt,
// ca = 3 dt, xmax = 8 dt, log_n_act = log(n_act), folded by the caller.
extern "C" int dust_pendulum_solve(
    const float* scal, const float* theta, const float* locs,
    const float* log_mix, const float* amat, const float* aseq,
    const float* actions, const float* lengths, const float* masses,
    float* theta_opt, float* theta_fwd, float* amat_out, float* a_mix,
    float* aseq_sel, float* weights, float* costs, int hz, int m,
    int n_params, int n_act, float dt, float xmax, float cg, float ca,
    float log_n_act, int exp_util, void* stream) {
  if (m < 1 || m > kMaxM || n_params < 1 || n_params > kMaxParams)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t floats = 4 * static_cast<size_t>(m) * hz +
                        3 * static_cast<size_t>(m) * n_act +
                        3 * kMaxM * kMaxM + 5 * kMaxM + 2 * kMaxParams +
                        2 * kWarps + 8 + 1;
  const RolloutConsts rk{dt, xmax, cg, ca};
  pendulum_solve_kernel<<<1, kThreads, floats * sizeof(float),
                          static_cast<cudaStream_t>(stream)>>>(
      scal, theta, locs, log_mix, amat, aseq, actions, lengths, masses,
      theta_opt, theta_fwd, amat_out, a_mix, aseq_sel, weights, costs, hz, m,
      n_params, n_act, rk, log_n_act, exp_util);
  return static_cast<int>(cudaGetLastError());
}
