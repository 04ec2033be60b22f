// The MPF Stein loop for the pendulum dynamics posterior as block-level
// device code, shared by the MPF kernel (K2, pendulum_mpf.cu) and the
// whole-episode kernel (K4/K5, pendulum_episode.cu).
//
// n_steps SVGD iterations on m (length, mass) particles held in shared
// memory, a quad of lanes per particle row (kRowLanes; the block's quads
// take the rows in turn). Each iteration, for every row i:
//   * GMM prior score over the fixed centers with an isotropic bandwidth
//     (max-subtracted softmax over the centers);
//   * the hand-derived gradient of the Gaussian observation likelihood
//     through one pendulum step, with the speed-clip gate and the
//     log-space chain rule;
//   * the RBF Stein direction in its folded drive form
//     phi_i = (sum_j k_ij (s_j - x_j/bw^2) + (sum_j k_ij) x_i/bw^2) / m;
//   * SGD: x_i += lr * phi_i.
// The arithmetic follows the plain PyTorch version
// (ops/mpf.py:pendulum_mpf_optimize_plain) operation by operation, the
// order of the sums over j too: lane l of a row's quad walks the columns
// j = l, l + 4, ... in order and the quad's partial sums meet in a fixed
// butterfly, (p0 + p1) + (p2 + p3) (ops/particle_mpf.py:lane_sum). The
// pairs' exps are one ex2.approx each with log2 e folded into the scale,
// within ~1e-6 relative of the plain version's exp. Every thread of the block must call it (it
// synchronises the block).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "stein.cuh"

namespace dust_mpf {

constexpr float kMaxSpeed = 8.0f;
constexpr float kMaxTorque = 2.0f;
constexpr float kPi = 3.14159265358979323846f;

// Lanes per particle row (ops/mpf.py:ROW_LANES).
constexpr int kRowLanes = 4;
// The max of v over a row's quad (fmaxf: NaN-ignoring, as the serial walk
// it replaces; the max is exact, so the order does not matter).
__device__ __forceinline__ float quad_fmax(float v, unsigned mask) {
#pragma unroll
  for (int o = 1; o < kRowLanes; o <<= 1)
    v = fmaxf(v, __shfl_xor_sync(mask, v, o));
  return v;
}

using dust_solve::ex2;
using dust_solve::kLog2e;

// sx0/sx1: particles (updated in place); sc0/sc1: prior centers;
// st0/st1 and su0/su1: scratch for the drive terms (odd iterations take
// su); sn0/sn1: scratch for the new particles (the iterations alternate
// between sx and sn); all shared, m floats each. One block barrier per
// iteration: a row's quad reads only its own new row before the next
// barrier, so a warp barrier orders it. Rows i = g, g + G, ... belong to quad g of the block's G =
// blockDim.x / 4 quads (blockDim.x a multiple of 32). theta0/theta_d0: the
// prediction start; loc0/loc1: the newest observation; half3g = 3 g 0.5.
__device__ inline void stein_loop(float* sx0, float* sx1, const float* sc0,
                                  const float* sc1, float* st0, float* st1,
                                  float* sn0, float* sn1, float* su0,
                                  float* su1, int m, int n_steps, float bw,
                                  float pbw, float lr, float sigma,
                                  float theta0, float theta_d0, float action,
                                  float loc0, float loc1, float dt,
                                  float half3g, int log_space) {
  using dust_solve::lane_group_sum;
  const int g = threadIdx.x / kRowLanes;
  const int l = threadIdx.x % kRowLanes;
  const int groups = blockDim.x / kRowLanes;
  const unsigned mask = dust_solve::lane_group_mask(kRowLanes);
  const float inv_pbw2 = 1.0f / (pbw * pbw);
  const float inv_bw2 = 1.0f / (bw * bw);
  // p_j = 2^(D_j cp - max), k_j = 2^(D_j ck), D the squared distance
  const float cp = -0.5f * inv_pbw2 * kLog2e;
  const float ck = -0.5f * inv_bw2 * kLog2e;
  const float inv_s2 = 1.0f / (sigma * sigma);
  const float acts = fminf(fmaxf(action, -kMaxTorque), kMaxTorque);
  const float sin_t = sinf(theta0 + kPi);
  const float fm = static_cast<float>(m);
  float* x0s = sx0;  // this iteration's particles
  float* x1s = sx1;
  float* n0s = sn0;  // the next iteration's
  float* n1s = sn1;

  for (int it = 0; it < n_steps; ++it) {
    float* const ta = it & 1 ? su0 : st0;  // this iteration's drive terms
    float* const tb = it & 1 ? su1 : st1;
    for (int i = g; i < m; i += groups) {
      const float x0 = x0s[i];
      const float x1 = x1s[i];
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
      float psum = 0.0f, pc0 = 0.0f, pc1 = 0.0f;
      float mx = -INFINITY;
#pragma unroll 4
      for (int j = l; j < m; j += kRowLanes) {
        const float d0 = x0 - sc0[j];
        const float d1 = x1 - sc1[j];
        mx = fmaxf(mx, (d0 * d0 + d1 * d1) * cp);
      }
      mx = quad_fmax(mx, mask);
#pragma unroll 4
      for (int j = l; j < m; j += kRowLanes) {
        const float d0 = x0 - sc0[j];
        const float d1 = x1 - sc1[j];
        const float p = ex2((d0 * d0 + d1 * d1) * cp - mx);
        psum = psum + p;
        pc0 = pc0 + p * sc0[j];
        pc1 = pc1 + p * sc1[j];
      }
      psum = lane_group_sum<kRowLanes>(psum, mask);
      pc0 = lane_group_sum<kRowLanes>(pc0, mask);
      pc1 = lane_group_sum<kRowLanes>(pc1, mask);
      const float gp0 = (pc0 / psum - x0) * inv_pbw2;
      const float gp1 = (pc1 / psum - x1) * inv_pbw2;
      if (l == 0) {
        ta[i] = (gl_l + gp0) - x0 * inv_bw2;
        tb[i] = (gl_m + gp1) - x1 * inv_bw2;
      }
    }
    __syncthreads();

    for (int i = g; i < m; i += groups) {
      // ---- RBF Stein direction, repulsion folded into the drive ----
      const float x0 = x0s[i];
      const float x1 = x1s[i];
      float rows = 0.0f, drive0 = 0.0f, drive1 = 0.0f;
#pragma unroll 4
      for (int j = l; j < m; j += kRowLanes) {
        const float d0 = x0 - x0s[j];
        const float d1 = x1 - x1s[j];
        const float k = ex2((d0 * d0 + d1 * d1) * ck);
        rows = rows + k;
        drive0 = drive0 + k * ta[j];
        drive1 = drive1 + k * tb[j];
      }
      rows = lane_group_sum<kRowLanes>(rows, mask);
      drive0 = lane_group_sum<kRowLanes>(drive0, mask);
      drive1 = lane_group_sum<kRowLanes>(drive1, mask);
      if (l == 0) {
        n0s[i] = x0 + lr * ((drive0 + rows * x0 * inv_bw2) / fm);
        n1s[i] = x1 + lr * ((drive1 + rows * x1 * inv_bw2) / fm);
      }
    }
    // no block barrier: the next iteration's first phase reads only the
    // quad's own new row and writes the other drive-term buffer; its
    // barrier orders everything else
    __syncwarp();
    float* t0 = x0s;
    float* t1 = x1s;
    x0s = n0s;
    x1s = n1s;
    n0s = t0;
    n1s = t1;
  }
  __syncthreads();
  if (x0s != sx0) {  // an odd count of iterations ended in sn
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      sx0[i] = x0s[i];
      sx1[i] = x1s[i];
    }
    __syncthreads();
  }
}

}  // namespace dust_mpf
