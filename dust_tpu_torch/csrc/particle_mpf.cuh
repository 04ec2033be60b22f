// The MPF Stein loops over the particle task's one-dimensional (log-)mass
// posterior as block-level device code: `mass_stein_loop`, shared by the
// whole-episode kernel (K9/K10, particle_episode.cu) and the MPF kernel's
// general path (K7, particle_mpf.cu), and `mass_stein_loop_reg`, K7's loop
// up to kLanes * kCols particles. K2's loops (pendulum_mpf.cuh) reduced to
// one dimension. The two give the same bits for one lane count.
//
// n_steps SVGD iterations on m particles, a group of lanes per particle
// row (the block's groups take the rows in turn). Each iteration, for
// every row i:
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
// operation by operation, the order of the sums over j too (lane l of a
// row's group walks j = l, l + lanes, ... in order, then the group's
// partial sums meet in a fixed butterfly, for a quad (p0 + p1) + (p2 +
// p3); ops/particle_mpf.py:lane_sum), except the pairs' exps: one
// ex2.approx each with log2 e folded into the scale, which agree with the
// plain version's exp to ~1e-6 relative. mass_stein_loop_reg takes the
// reciprocals as rcp.rn and the quotients through them (stein.cuh:div_rn):
// the IEEE quotients' bits, as mass_stein_loop's divisions.
// Every thread of the block must call them (they synchronise the block).

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

// Lanes per particle row in K7 and K9/K10: a quad of neighbouring lanes
// shares a row, lane l of the quad walks the columns j = l, l + 4, ... in
// order, and the quad's partial sums meet in a fixed butterfly, (p0 + p1)
// + (p2 + p3) (ops/particle_mpf.py:ROW_LANES, lane_sum).
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

// ---- K7's register loop ----------------------------------------------------

// The phases of K7 that its clocked build times (ops/particle_mpf.py:
// CLOCK_PHASES, phase_clock.cuh); the loop marks the two of an iteration.
enum : int {
  kMpfClkLoad = 0, kMpfClkPrior, kMpfClkDrive, kMpfClkStore, kMpfClkPhases
};

// The constants of K7's register loop, from the scalars.
struct MassConsts {
  float inv_pbw2, inv_bw2, inv_s2, cp, ck, fm, inv_fm;
};

__device__ __forceinline__ MassConsts mass_consts(const MassMpf& k, int m) {
  MassConsts c;
  c.inv_pbw2 = 1.0f / (k.pbw * k.pbw);
  c.inv_bw2 = 1.0f / (k.bw * k.bw);
  c.inv_s2 = 1.0f / (k.sigma * k.sigma);
  // the exponents in base 2, log2 e folded in: p_j = 2^(d_j^2 cp - max),
  // k_j = 2^(d_j^2 ck), each one ex2.approx
  c.cp = -0.5f * c.inv_pbw2 * kLog2e;
  c.ck = -0.5f * c.inv_bw2 * kLog2e;
  c.fm = static_cast<float>(m);
  c.inv_fm = 1.0f / c.fm;
  return c;
}

// The likelihood gradient of the particle x0 (hand-derived particle
// physics); the reciprocal of the mass as rcp.rn, the IEEE 1 / mass.
__device__ __forceinline__ float mass_lik_grad(float x0, const MassMpf& k,
                                               const MassConsts& c, float ma,
                                               float ms, int log_space) {
  const float mass = log_space ? expf(x0) : x0;
  const float invm = __frcp_rn(mass);
  float gl = vel_grad_term(k.ax, k.v0x, k.loc_vx, invm, k.scale, c.inv_s2,
                           ma, ms) +
             vel_grad_term(k.ay, k.v0y, k.loc_vy, invm, k.scale, c.inv_s2,
                           ma, ms);
  if (log_space) gl = gl * mass;
  return gl;
}

// The drive term s_i - x_i / bw^2 of row x0 from the likelihood gradient
// gl and the group's prior sums psum, pc: s_i = gl + (pc / psum - x0) /
// prior_bw^2, the quotient through the reciprocal of psum (div_rn).
__device__ __forceinline__ float mass_drive_term(float x0, float gl,
                                                 float psum, float pc,
                                                 const MassConsts& c) {
  const float gp =
      (dust_solve::div_rn(pc, psum, __frcp_rn(psum)) - x0) * c.inv_pbw2;
  return (gl + gp) - x0 * c.inv_bw2;
}

// The row's new particle from the group's drive sums: x0 + lr * (drive +
// rows x0 / bw^2) / m, the division by m through its reciprocal (div_rn).
__device__ __forceinline__ float mass_update(float x0, float rows,
                                             float drive, const MassMpf& k,
                                             const MassConsts& c) {
  return x0 + k.lr * dust_solve::div_rn(drive + rows * x0 * c.inv_bw2,
                                        c.fm, c.inv_fm);
}

// K7's loop for m <= kLanes * kCols particles, one row per group
// (blockDim.x >= kLanes * m): row i = g is held in a register by its
// group's lanes, and lane l keeps the centers j = l, l + kLanes, ... (at
// most kCols) in registers, with its squared distances to them from the
// max pass to the exp pass. x_in, centers, x_out [m] in device memory;
// xt: 2 * m float2 of shared memory, the (particle, drive term) pairs of
// two iterations in turn, so the drive walk reads one float2 per column.
// One block barrier per iteration, between the prior score (which reads
// only registers) and the drive walk: iteration it writes the pairs of
// buffer it & 1, which the walk of iteration it - 2 read before the
// barrier of iteration it - 1.
template <int kLanes, int kCols, class Clock>
__device__ inline void mass_stein_loop_reg(
    const float* __restrict__ x_in, const float* __restrict__ centers,
    float* __restrict__ x_out, float2* xt, int m, int n_steps,
    const MassMpf& k, float ma, float ms, int log_space, Clock& clk) {
  using dust_solve::lane_group_sum;
  const int i = threadIdx.x / kLanes;  // this group's row
  const int l = threadIdx.x % kLanes;
  const unsigned mask = dust_solve::lane_group_mask(kLanes);
  const bool row = i < m;
  const MassConsts c = mass_consts(k, m);
  // this lane's columns j = l + kLanes q, q < nc
  const int nc = row ? (m - l + kLanes - 1) / kLanes : 0;
  float cc[kCols], dc[kCols];
  float x0 = row ? x_in[i] : 0.0f;
#pragma unroll
  for (int q = 0; q < kCols; ++q)
    cc[q] = q < nc ? centers[l + kLanes * q] : 0.0f;
  clk.mark(kMpfClkLoad);

  for (int it = 0; it < n_steps; ++it) {
    float2* const xa = xt + (it & 1) * m;
    if (row) {
      const float gl = mass_lik_grad(x0, k, c, ma, ms, log_space);
      // ---- GMM prior score over the fixed centers ----
      // the max with fmaxf (K2's): a NaN term still makes psum NaN
      float mx = -INFINITY;
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        if (q < nc) {
          const float d = x0 - cc[q];
          dc[q] = (d * d) * c.cp;
          mx = fmaxf(mx, dc[q]);
        }
      }
      mx = dust_solve::lane_group_fmax<kLanes>(mx, mask);
      float psum = 0.0f, pc = 0.0f;
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        if (q < nc) {
          const float p = ex2(dc[q] - mx);
          psum = psum + p;
          pc = pc + p * cc[q];
        }
      }
      psum = lane_group_sum<kLanes>(psum, mask);
      pc = lane_group_sum<kLanes>(pc, mask);
      if (l == 0) xa[i] = make_float2(x0, mass_drive_term(x0, gl, psum, pc, c));
    }
    __syncthreads();
    clk.mark(kMpfClkPrior);

    if (row) {
      // ---- RBF Stein direction, repulsion folded into the drive ----
      float rows = 0.0f, drive = 0.0f;
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        if (q < nc) {
          const float2 v = xa[l + kLanes * q];
          const float d = x0 - v.x;
          const float kk = ex2((d * d) * c.ck);
          rows = rows + kk;
          drive = drive + kk * v.y;
        }
      }
      rows = lane_group_sum<kLanes>(rows, mask);
      drive = lane_group_sum<kLanes>(drive, mask);
      x0 = mass_update(x0, rows, drive, k, c);
    }
    clk.mark(kMpfClkDrive);
  }
  if (row && l == 0) x_out[i] = x0;
  clk.mark(kMpfClkStore);
}

}  // namespace dust_particle
