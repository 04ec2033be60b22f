// The MPF Stein loop over the particle task's one-dimensional (log-)mass
// posterior as block-level device code, shared by the MPF kernel (K7,
// particle_mpf.cu) and the whole-episode kernel (K9, particle_episode.cu).
// K2's loop (pendulum_mpf.cuh) reduced to one dimension.
//
// n_steps SVGD iterations on m particles held in shared memory, a quad of
// lanes per particle row (kRowLanes; the block's quads take the rows in
// turn). Each iteration, for every row i:
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
// operation by operation, the order of the sums over j too (the quad's
// lanes' partial sums, then the butterfly), except the pairs' exps: one
// ex2.approx each with log2 e folded into the scale, which agree with the
// plain version's exp to ~1e-6 relative.
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

// Lanes per particle row: a quad of neighbouring lanes shares a row, lane
// l of the quad walks the columns j = l, l + 4, ... in order, and the
// quad's partial sums meet in a fixed butterfly, (p0 + p1) + (p2 + p3)
// (ops/particle_mpf.py:ROW_LANES, lane_sum).
constexpr int kRowLanes = 4;
using dust_solve::ex2;
using dust_solve::kLog2e;

// sx: particles (updated in place); sc: prior centers; st: scratch for
// the drive terms; sn: scratch for the new particles; all shared, m floats
// each. Rows i = g, g + G, ... belong to quad g of the block's G =
// blockDim.x / 4 quads (blockDim.x a multiple of 32).
__device__ inline void mass_stein_loop(float* sx, const float* sc, float* st,
                                       float* sn, int m, int n_steps,
                                       const MassMpf& k, float ma, float ms,
                                       int log_space) {
  const int g = threadIdx.x / kRowLanes;
  const int l = threadIdx.x % kRowLanes;
  const int groups = blockDim.x / kRowLanes;
  const unsigned mask = dust_solve::lane_group_mask(kRowLanes);
  const float inv_pbw2 = 1.0f / (k.pbw * k.pbw);
  const float inv_bw2 = 1.0f / (k.bw * k.bw);
  const float inv_s2 = 1.0f / (k.sigma * k.sigma);
  const float fm = static_cast<float>(m);
  // the exponents in base 2, log2 e folded in: p_j = 2^(d_j^2 cp - max),
  // k_j = 2^(d_j^2 ck), each one ex2.approx
  const float cp = -0.5f * inv_pbw2 * kLog2e;
  const float ck = -0.5f * inv_bw2 * kLog2e;

  for (int it = 0; it < n_steps; ++it) {
    for (int i = g; i < m; i += groups) {
      const float x0 = sx[i];
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
#pragma unroll 4
      for (int j = l; j < m; j += kRowLanes) {
        const float d = x0 - sc[j];
        mx = dust_solve::maxp(mx, (d * d) * cp);
      }
      mx = dust_solve::lane_group_max<kRowLanes>(mx, mask);
      float psum = 0.0f, pc = 0.0f;
#pragma unroll 4
      for (int j = l; j < m; j += kRowLanes) {
        const float d = x0 - sc[j];
        const float p = ex2((d * d) * cp - mx);
        psum = psum + p;
        pc = pc + p * sc[j];
      }
      psum = dust_solve::lane_group_sum<kRowLanes>(psum, mask);
      pc = dust_solve::lane_group_sum<kRowLanes>(pc, mask);
      const float gp = (pc / psum - x0) * inv_pbw2;
      if (l == 0) st[i] = (gl + gp) - x0 * inv_bw2;
    }
    __syncthreads();

    for (int i = g; i < m; i += groups) {
      // ---- RBF Stein direction, repulsion folded into the drive ----
      const float x0 = sx[i];
      float rows = 0.0f, drive = 0.0f;
#pragma unroll 4
      for (int j = l; j < m; j += kRowLanes) {
        const float d = x0 - sx[j];
        const float kk = ex2((d * d) * ck);
        rows = rows + kk;
        drive = drive + kk * st[j];
      }
      rows = dust_solve::lane_group_sum<kRowLanes>(rows, mask);
      drive = dust_solve::lane_group_sum<kRowLanes>(drive, mask);
      const float phi = (drive + rows * x0 * inv_bw2) / fm;
      if (l == 0) sn[i] = x0 + k.lr * phi;
    }
    __syncthreads();  // every row has read sx before any row writes it
    for (int i = threadIdx.x; i < m; i += blockDim.x) sx[i] = sn[i];
    __syncthreads();
  }
}

}  // namespace dust_particle
