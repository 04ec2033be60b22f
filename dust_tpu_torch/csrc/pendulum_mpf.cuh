// The MPF Stein loop for the pendulum dynamics posterior as block-level
// device code, shared by the MPF kernel (K2, pendulum_mpf.cu) and the
// whole-episode kernel (K4/K5, pendulum_episode.cu).
//
// n_steps SVGD iterations on m (length, mass) particles, a group of kLanes
// lanes per particle row (the block's groups take the rows in turn). Each
// iteration, for every row i:
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
// order of the sums over j too: lane l of a row's group walks the columns
// j = l, l + kLanes, ... in order and the group's partial sums meet in a
// fixed butterfly, for a quad (p0 + p1) + (p2 + p3)
// (ops/particle_mpf.py:lane_sum). The pairs' exps are one ex2.approx each
// with log2 e folded into the scale, within ~1e-6 relative of the plain
// version's exp. Two loops: `stein_loop` walks particles and centers in
// shared memory (K4/K5 with a quad, K2 above its register ceiling);
// `stein_loop_reg` (K2 up to kLanes * kCols particles) keeps each lane's
// centers and its squared distances to them in registers. Both give the
// same bits for one lane count. Every thread of the block must call them
// (they synchronise the block).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "stein.cuh"

namespace dust_mpf {

constexpr float kMaxSpeed = 8.0f;
constexpr float kMaxTorque = 2.0f;
constexpr float kPi = 3.14159265358979323846f;

// Lanes per particle row in K4/K5 (ops/mpf.py:EPISODE_ROW_LANES).
constexpr int kRowLanes = 4;

// The phases of K2 that its clocked build times (ops/mpf.py:CLOCK_PHASES,
// phase_clock.cuh); the loops mark the two of an iteration.
enum : int { kClkLoad = 0, kClkPrior, kClkDrive, kClkStore, kClkPhases };

// The clock of the MPF loop inside the episode kernels: times nothing.
struct NoClock {
  __device__ __forceinline__ void mark(int) {}
};

using dust_solve::ex2;
using dust_solve::kLog2e;

// The constants of an MPF loop. theta0/theta_d0: the prediction start;
// loc0/loc1: the newest observation; half3g = 3 g 0.5.
struct MpfConsts {
  float inv_pbw2, inv_bw2, cp, ck, inv_s2, acts, sin_t, lr, fm;
  float theta0, theta_d0, loc0, loc1, dt, half3g;
  int log_space;
};

__device__ __forceinline__ MpfConsts mpf_consts(
    int m, float bw, float pbw, float lr, float sigma, float theta0,
    float theta_d0, float action, float loc0, float loc1, float dt,
    float half3g, int log_space) {
  MpfConsts k;
  k.inv_pbw2 = 1.0f / (pbw * pbw);
  k.inv_bw2 = 1.0f / (bw * bw);
  // p_j = 2^(D_j cp - max), k_j = 2^(D_j ck), D the squared distance
  k.cp = -0.5f * k.inv_pbw2 * kLog2e;
  k.ck = -0.5f * k.inv_bw2 * kLog2e;
  k.inv_s2 = 1.0f / (sigma * sigma);
  k.acts = fminf(fmaxf(action, -kMaxTorque), kMaxTorque);
  k.sin_t = sinf(theta0 + kPi);
  k.lr = lr;
  k.fm = static_cast<float>(m);
  k.theta0 = theta0;
  k.theta_d0 = theta_d0;
  k.loc0 = loc0;
  k.loc1 = loc1;
  k.dt = dt;
  k.half3g = half3g;
  k.log_space = log_space;
  return k;
}

// The likelihood gradient of particle (x0, x1) (hand-derived pendulum
// physics): gl_l, gl_m.
__device__ __forceinline__ void lik_grad(float x0, float x1,
                                         const MpfConsts& k, float& gl_l,
                                         float& gl_m) {
  float length = x0;
  float mass = x1;
  if (k.log_space) {
    length = expf(length);
    mass = expf(mass);
  }
  const float il = 1.0f / length;
  const float im = 1.0f / mass;
  const float tdd = (-k.half3g) * il * k.sin_t + 3.0f * im * il * il * k.acts;
  const float theta_d_raw = k.theta_d0 + k.dt * tdd;
  const float theta_d = fminf(fmaxf(theta_d_raw, -kMaxSpeed), kMaxSpeed);
  const float theta = k.theta0 + theta_d * k.dt;
  const float gate =
      (theta_d_raw > -kMaxSpeed && theta_d_raw < kMaxSpeed) ? 1.0f : 0.0f;
  const float dtd_dl =
      gate * k.dt *
      (k.half3g * il * il * k.sin_t - 6.0f * im * il * il * il * k.acts);
  const float dtd_dm = gate * k.dt * (-3.0f * im * im * il * il * k.acts);
  const float r0 = theta - k.loc0;
  const float r1 = theta_d - k.loc1;
  const float common = -(r0 * k.dt + r1) * k.inv_s2;
  gl_l = common * dtd_dl;
  gl_m = common * dtd_dm;
  if (k.log_space) {
    gl_l = gl_l * length;
    gl_m = gl_m * mass;
  }
}

// sx0/sx1: particles (updated in place); sc0/sc1: prior centers;
// st0/st1 and su0/su1: scratch for the drive terms (odd iterations take
// su); sn0/sn1: scratch for the new particles (the iterations alternate
// between sx and sn); all shared, m floats each. One block barrier per
// iteration: a row's group reads only its own new row before the next
// barrier, so a warp barrier orders it. Rows i = g, g + G, ... belong to
// group g of the block's G = blockDim.x / kLanes groups (blockDim.x a
// multiple of 32). clk marks kClkPrior and kClkDrive each iteration.
template <int kLanes, class Clock>
__device__ inline void stein_loop(float* sx0, float* sx1, const float* sc0,
                                  const float* sc1, float* st0, float* st1,
                                  float* sn0, float* sn1, float* su0,
                                  float* su1, int m, int n_steps,
                                  const MpfConsts& k, Clock& clk) {
  using dust_solve::lane_group_sum;
  const int g = threadIdx.x / kLanes;
  const int l = threadIdx.x % kLanes;
  const int groups = blockDim.x / kLanes;
  const unsigned mask = dust_solve::lane_group_mask(kLanes);
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
      float gl_l, gl_m;
      lik_grad(x0, x1, k, gl_l, gl_m);
      // ---- GMM prior score over the fixed centers ----
      float psum = 0.0f, pc0 = 0.0f, pc1 = 0.0f;
      float mx = -INFINITY;
#pragma unroll 4
      for (int j = l; j < m; j += kLanes) {
        const float d0 = x0 - sc0[j];
        const float d1 = x1 - sc1[j];
        mx = fmaxf(mx, (d0 * d0 + d1 * d1) * k.cp);
      }
      mx = dust_solve::lane_group_fmax<kLanes>(mx, mask);
#pragma unroll 4
      for (int j = l; j < m; j += kLanes) {
        const float d0 = x0 - sc0[j];
        const float d1 = x1 - sc1[j];
        const float p = ex2((d0 * d0 + d1 * d1) * k.cp - mx);
        psum = psum + p;
        pc0 = pc0 + p * sc0[j];
        pc1 = pc1 + p * sc1[j];
      }
      psum = lane_group_sum<kLanes>(psum, mask);
      pc0 = lane_group_sum<kLanes>(pc0, mask);
      pc1 = lane_group_sum<kLanes>(pc1, mask);
      const float gp0 = (pc0 / psum - x0) * k.inv_pbw2;
      const float gp1 = (pc1 / psum - x1) * k.inv_pbw2;
      if (l == 0) {
        ta[i] = (gl_l + gp0) - x0 * k.inv_bw2;
        tb[i] = (gl_m + gp1) - x1 * k.inv_bw2;
      }
    }
    __syncthreads();
    clk.mark(kClkPrior);

    for (int i = g; i < m; i += groups) {
      // ---- RBF Stein direction, repulsion folded into the drive ----
      const float x0 = x0s[i];
      const float x1 = x1s[i];
      float rows = 0.0f, drive0 = 0.0f, drive1 = 0.0f;
#pragma unroll 4
      for (int j = l; j < m; j += kLanes) {
        const float d0 = x0 - x0s[j];
        const float d1 = x1 - x1s[j];
        const float kk = ex2((d0 * d0 + d1 * d1) * k.ck);
        rows = rows + kk;
        drive0 = drive0 + kk * ta[j];
        drive1 = drive1 + kk * tb[j];
      }
      rows = lane_group_sum<kLanes>(rows, mask);
      drive0 = lane_group_sum<kLanes>(drive0, mask);
      drive1 = lane_group_sum<kLanes>(drive1, mask);
      if (l == 0) {
        n0s[i] = x0 + k.lr * ((drive0 + rows * x0 * k.inv_bw2) / k.fm);
        n1s[i] = x1 + k.lr * ((drive1 + rows * x1 * k.inv_bw2) / k.fm);
      }
    }
    // no block barrier: the next iteration's first phase reads only the
    // group's own new row and writes the other drive-term buffer; its
    // barrier orders everything else
    __syncwarp();
    clk.mark(kClkDrive);
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

// The loop for m <= kLanes * kCols particles, one row per group (blockDim.x
// >= kLanes * m): row i = g is held in registers by its group's lanes, and
// lane l keeps the centers j = l, l + kLanes, ... (at most kCols) in
// registers, with its squared distances to them from the max pass to the
// exp pass. x_in, centers, x_out [m, 2] in device memory; xs and ts: 2 * m
// float2 of shared memory each, the particles and drive terms of two
// iterations in turn. One block barrier per iteration, between the prior
// score (which reads only registers) and the drive walk. The divisions by
// the row's prior weight sum and by m go through their reciprocals
// (stein.cuh:div_rn). The same bits as stein_loop<kLanes>.
template <int kLanes, int kCols, class Clock>
__device__ inline void stein_loop_reg(const float* __restrict__ x_in,
                                      const float* __restrict__ centers,
                                      float* __restrict__ x_out, float2* xs,
                                      float2* ts, int m, int n_steps,
                                      const MpfConsts& k, Clock& clk) {
  using dust_solve::div_rn;
  using dust_solve::lane_group_sum;
  const int i = threadIdx.x / kLanes;  // this group's row
  const int l = threadIdx.x % kLanes;
  const unsigned mask = dust_solve::lane_group_mask(kLanes);
  const bool row = i < m;
  const float inv_fm = 1.0f / k.fm;
  // this lane's columns j = l + kLanes c, c < nc
  const int nc = row ? (m - l + kLanes - 1) / kLanes : 0;
  float c0[kCols], c1[kCols], dc[kCols];
  float x0 = 0.0f, x1 = 0.0f;
  if (row) {
    x0 = x_in[2 * i];
    x1 = x_in[2 * i + 1];
  }
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int j = l + kLanes * c;
    c0[c] = c < nc ? centers[2 * j] : 0.0f;
    c1[c] = c < nc ? centers[2 * j + 1] : 0.0f;
  }
  if (row && l == 0) xs[i] = make_float2(x0, x1);
  clk.mark(kClkLoad);

  for (int it = 0; it < n_steps; ++it) {
    const float2* const xa = xs + (it & 1) * m;  // this iteration's
    float2* const xn = xs + ((it + 1) & 1) * m;   // the next one's
    float2* const ta = ts + (it & 1) * m;
    if (row) {
      float gl_l, gl_m;
      lik_grad(x0, x1, k, gl_l, gl_m);
      // ---- GMM prior score over the fixed centers ----
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        if (c < nc) {
          const float d0 = x0 - c0[c];
          const float d1 = x1 - c1[c];
          dc[c] = (d0 * d0 + d1 * d1) * k.cp;
          mx = fmaxf(mx, dc[c]);
        }
      }
      mx = dust_solve::lane_group_fmax<kLanes>(mx, mask);
      float psum = 0.0f, pc0 = 0.0f, pc1 = 0.0f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        if (c < nc) {
          const float p = ex2(dc[c] - mx);
          psum = psum + p;
          pc0 = pc0 + p * c0[c];
          pc1 = pc1 + p * c1[c];
        }
      }
      psum = lane_group_sum<kLanes>(psum, mask);
      pc0 = lane_group_sum<kLanes>(pc0, mask);
      pc1 = lane_group_sum<kLanes>(pc1, mask);
      const float ips = 1.0f / psum;
      const float gp0 = (div_rn(pc0, psum, ips) - x0) * k.inv_pbw2;
      const float gp1 = (div_rn(pc1, psum, ips) - x1) * k.inv_pbw2;
      if (l == 0)
        ta[i] = make_float2((gl_l + gp0) - x0 * k.inv_bw2,
                            (gl_m + gp1) - x1 * k.inv_bw2);
    }
    __syncthreads();
    clk.mark(kClkPrior);

    if (row) {
      // ---- RBF Stein direction, repulsion folded into the drive ----
      float rows = 0.0f, drive0 = 0.0f, drive1 = 0.0f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        if (c < nc) {
          const int j = l + kLanes * c;
          const float2 xj = xa[j];
          const float2 tj = ta[j];
          const float d0 = x0 - xj.x;
          const float d1 = x1 - xj.y;
          const float kk = ex2((d0 * d0 + d1 * d1) * k.ck);
          rows = rows + kk;
          drive0 = drive0 + kk * tj.x;
          drive1 = drive1 + kk * tj.y;
        }
      }
      rows = lane_group_sum<kLanes>(rows, mask);
      drive0 = lane_group_sum<kLanes>(drive0, mask);
      drive1 = lane_group_sum<kLanes>(drive1, mask);
      x0 = x0 + k.lr * div_rn(drive0 + rows * x0 * k.inv_bw2, k.fm, inv_fm);
      x1 = x1 + k.lr * div_rn(drive1 + rows * x1 * k.inv_bw2, k.fm, inv_fm);
      // read by the other rows after the next iteration's barrier, which
      // this buffer's previous readers (the last iteration's walk) passed
      if (l == 0) xn[i] = make_float2(x0, x1);
    }
    clk.mark(kClkDrive);
  }
  if (row && l == 0) {
    x_out[2 * i] = x0;
    x_out[2 * i + 1] = x1;
  }
  clk.mark(kClkStore);
}

}  // namespace dust_mpf
