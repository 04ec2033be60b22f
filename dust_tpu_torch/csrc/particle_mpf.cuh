// The MPF Stein loop over the particle task's one-dimensional (log-)mass
// posterior as block-level device code, shared by the MPF kernel (K7,
// particle_mpf.cu) and the whole-episode kernel (K9, particle_episode.cu).
// K2's loop (pendulum_mpf.cuh) reduced to one dimension.
//
// n_steps SVGD iterations on m particles held in shared memory, one
// thread per particle row (threadIdx.x < m; the block may be wider, and
// its other threads enter no sum). Each iteration, for every row i:
//   * the gradient of the Gaussian observation likelihood through one
//     acceleration-control Particle.step: the mass enters only the
//     velocity prediction v = clip(v0 + clip(a / mass, +-max_acc) *
//     scale, +-max_speed), with the strict-interior gates of both clips
//     and, in log space, the chain-rule factor mass;
//   * the GMM prior score over the fixed centers with an isotropic
//     bandwidth (max-subtracted softmax over the centers);
//   * the RBF Stein direction in its folded drive form
//     phi_i = (sum_j k_ij (s_j - x_j/bw^2) + (sum_j k_ij) x_i/bw^2) / m;
//   * SGD: x_i += lr * phi_i.
// The arithmetic follows ops/particle_mpf.py:particle_mpf_optimize_plain
// operation by operation; only the order of the sums over j differs.
// Every thread of the block must call it (it synchronises the block).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "stein.cuh"

namespace dust_particle {

// The loop's scalars: [bw, prior_bw, lr, sigma, v0x, v0y, ax, ay, loc_vx,
// loc_vy, scale] (ops/particle_mpf.py:mpf_scalars).
struct MassMpf {
  float bw, pbw, lr, sigma, v0x, v0y, ax, ay, loc_vx, loc_vy, scale;
};

// -(pred - loc) / sigma^2 * dpred/dmass for one velocity component.
__device__ __forceinline__ float vel_grad_term(float a, float v0, float loc,
                                               float invm, float scale,
                                               float inv_s2, float ma,
                                               float ms) {
  const float acc_raw = a * invm;
  const float acc = dust_solve::clampf(acc_raw, -ma, ma);
  const float g_a = (acc_raw > -ma && acc_raw < ma) ? 1.0f : 0.0f;
  const float v_raw = v0 + acc * scale;
  const float pred = dust_solve::clampf(v_raw, -ms, ms);
  const float g_v = (v_raw > -ms && v_raw < ms) ? 1.0f : 0.0f;
  const float dpred = g_v * g_a * (-a * invm * invm) * scale;
  return -(pred - loc) * inv_s2 * dpred;
}

// sx: particles (updated in place); sc: prior centers; st: scratch for
// the drive terms; all shared, m floats each.
__device__ inline void mass_stein_loop(float* sx, const float* sc, float* st,
                                       int m, int n_steps, const MassMpf& k,
                                       float ma, float ms, int log_space) {
  const int i = threadIdx.x;
  const bool row = i < m;
  const float inv_pbw2 = 1.0f / (k.pbw * k.pbw);
  const float inv_bw2 = 1.0f / (k.bw * k.bw);
  const float inv_s2 = 1.0f / (k.sigma * k.sigma);
  const float fm = static_cast<float>(m);

  for (int it = 0; it < n_steps; ++it) {
    float x0 = 0.0f;
    if (row) {
      x0 = sx[i];
      const float mass = log_space ? expf(x0) : x0;
      const float invm = 1.0f / mass;
      // ---- likelihood gradient (hand-derived particle physics) ----
      float gl = vel_grad_term(k.ax, k.v0x, k.loc_vx, invm, k.scale, inv_s2,
                               ma, ms) +
                 vel_grad_term(k.ay, k.v0y, k.loc_vy, invm, k.scale, inv_s2,
                               ma, ms);
      if (log_space) gl = gl * mass;
      // ---- GMM prior score over the fixed centers ----
      float mx = -INFINITY;
      for (int j = 0; j < m; ++j) {
        const float d = x0 - sc[j];
        mx = dust_solve::maxp(mx, -0.5f * (d * d) * inv_pbw2);
      }
      float psum = 0.0f, pc = 0.0f;
      for (int j = 0; j < m; ++j) {
        const float d = x0 - sc[j];
        const float p = expf(-0.5f * (d * d) * inv_pbw2 - mx);
        psum = psum + p;
        pc = pc + p * sc[j];
      }
      const float gp = (pc / psum - x0) * inv_pbw2;
      st[i] = (gl + gp) - x0 * inv_bw2;
    }
    __syncthreads();

    float nx = 0.0f;
    if (row) {
      // ---- RBF Stein direction, repulsion folded into the drive ----
      float rows = 0.0f, drive = 0.0f;
      for (int j = 0; j < m; ++j) {
        const float d = x0 - sx[j];
        const float kk = expf(-0.5f * (d * d) * inv_bw2);
        rows = rows + kk;
        drive = drive + kk * st[j];
      }
      const float phi = (drive + rows * x0 * inv_bw2) / fm;
      nx = x0 + k.lr * phi;
    }
    __syncthreads();  // every row has read sx before any row writes it
    if (row) sx[i] = nx;
    __syncthreads();
  }
}

}  // namespace dust_particle
