// The MPF Stein loop for the pendulum dynamics posterior as block-level
// device code, shared by the MPF kernel (K2, pendulum_mpf.cu) and the
// whole-episode kernel (K4/K5, pendulum_episode.cu).
//
// n_steps SVGD iterations on m (length, mass) particles held in shared
// memory, one thread per particle row (threadIdx.x < m; the block may be
// wider). Each iteration, for every row i:
//   * GMM prior score over the fixed centers with an isotropic bandwidth
//     (max-subtracted softmax over the centers);
//   * the hand-derived gradient of the Gaussian observation likelihood
//     through one pendulum step, with the speed-clip gate and the
//     log-space chain rule;
//   * the RBF Stein direction in its folded drive form
//     phi_i = (sum_j k_ij (s_j - x_j/bw^2) + (sum_j k_ij) x_i/bw^2) / m;
//   * SGD: x_i += lr * phi_i.
// The arithmetic follows the plain PyTorch version
// (ops/mpf.py:pendulum_mpf_optimize_plain) operation by operation; only
// the order of the sums over j differs. Every thread of the block must
// call it (it synchronises the block).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace dust_mpf {

constexpr float kMaxSpeed = 8.0f;
constexpr float kMaxTorque = 2.0f;
constexpr float kPi = 3.14159265358979323846f;

// sx0/sx1: particles (updated in place); sc0/sc1: prior centers;
// st0/st1: scratch for the drive terms; all shared, m floats each.
// theta0/theta_d0: the prediction start; loc0/loc1: the newest
// observation; half3g = 3 g 0.5.
__device__ inline void stein_loop(float* sx0, float* sx1, const float* sc0,
                                  const float* sc1, float* st0, float* st1,
                                  int m, int n_steps, float bw, float pbw,
                                  float lr, float sigma, float theta0,
                                  float theta_d0, float action, float loc0,
                                  float loc1, float dt, float half3g,
                                  int log_space) {
  const int i = threadIdx.x;
  const bool row = i < m;
  const float inv_pbw2 = 1.0f / (pbw * pbw);
  const float inv_bw2 = 1.0f / (bw * bw);
  const float inv_s2 = 1.0f / (sigma * sigma);
  const float acts = fminf(fmaxf(action, -kMaxTorque), kMaxTorque);
  const float sin_t = sinf(theta0 + kPi);
  const float fm = static_cast<float>(m);

  for (int it = 0; it < n_steps; ++it) {
    float x0 = 0.0f, x1 = 0.0f;
    if (row) {
      x0 = sx0[i];
      x1 = sx1[i];
      float length = x0;
      float mass = x1;
      if (log_space) {
        length = expf(length);
        mass = expf(mass);
      }
      // ---- likelihood gradient (hand-derived pendulum physics) ----
      const float il = 1.0f / length;
      const float im = 1.0f / mass;
      const float tdd = (-half3g) * il * sin_t + 3.0f * im * il * il * acts;
      const float theta_d_raw = theta_d0 + dt * tdd;
      const float theta_d = fminf(fmaxf(theta_d_raw, -kMaxSpeed), kMaxSpeed);
      const float theta = theta0 + theta_d * dt;
      const float gate =
          (theta_d_raw > -kMaxSpeed && theta_d_raw < kMaxSpeed) ? 1.0f : 0.0f;
      const float dtd_dl =
          gate * dt *
          (half3g * il * il * sin_t - 6.0f * im * il * il * il * acts);
      const float dtd_dm = gate * dt * (-3.0f * im * im * il * il * acts);
      const float r0 = theta - loc0;
      const float r1 = theta_d - loc1;
      const float common = -(r0 * dt + r1) * inv_s2;
      float gl_l = common * dtd_dl;
      float gl_m = common * dtd_dm;
      if (log_space) {
        gl_l = gl_l * length;
        gl_m = gl_m * mass;
      }
      // ---- GMM prior score over the fixed centers ----
      float mx = -INFINITY;
      for (int j = 0; j < m; ++j) {
        const float d0 = x0 - sc0[j];
        const float d1 = x1 - sc1[j];
        mx = fmaxf(mx, -0.5f * (d0 * d0 + d1 * d1) * inv_pbw2);
      }
      float psum = 0.0f, pc0 = 0.0f, pc1 = 0.0f;
      for (int j = 0; j < m; ++j) {
        const float d0 = x0 - sc0[j];
        const float d1 = x1 - sc1[j];
        const float p = expf(-0.5f * (d0 * d0 + d1 * d1) * inv_pbw2 - mx);
        psum = psum + p;
        pc0 = pc0 + p * sc0[j];
        pc1 = pc1 + p * sc1[j];
      }
      const float gp0 = (pc0 / psum - x0) * inv_pbw2;
      const float gp1 = (pc1 / psum - x1) * inv_pbw2;
      st0[i] = (gl_l + gp0) - x0 * inv_bw2;
      st1[i] = (gl_m + gp1) - x1 * inv_bw2;
    }
    __syncthreads();

    float nx0 = 0.0f, nx1 = 0.0f;
    if (row) {
      // ---- RBF Stein direction, repulsion folded into the drive ----
      float rows = 0.0f, drive0 = 0.0f, drive1 = 0.0f;
      for (int j = 0; j < m; ++j) {
        const float d0 = x0 - sx0[j];
        const float d1 = x1 - sx1[j];
        const float k = expf(-0.5f * (d0 * d0 + d1 * d1) * inv_bw2);
        rows = rows + k;
        drive0 = drive0 + k * st0[j];
        drive1 = drive1 + k * st1[j];
      }
      const float phi0 = (drive0 + rows * x0 * inv_bw2) / fm;
      const float phi1 = (drive1 + rows * x1 * inv_bw2) / fm;
      nx0 = x0 + lr * phi0;
      nx1 = x1 + lr * phi1;
    }
    __syncthreads();  // every row has read sx before any row writes it
    if (row) {
      sx0[i] = nx0;
      sx1[i] = nx1;
    }
    __syncthreads();
  }
}

}  // namespace dust_mpf
