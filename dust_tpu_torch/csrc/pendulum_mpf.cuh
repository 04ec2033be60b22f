// The MPF Stein loop over a two-parameter dynamics posterior as
// block-level device code, shared by the pendulum's MPF kernel (K2,
// pendulum_mpf.cu) and whole-episode kernel (K4/K5, pendulum_episode.cu)
// and the cart-pole's episode kernel (K14, cartpole_episode.cu).
//
// n_steps SVGD iterations on m two-parameter particles, a group of kLanes
// lanes per particle row (the block's groups take the rows in turn). Each
// iteration, for every row i:
//   * GMM prior score over the fixed centers with an isotropic bandwidth
//     (max-subtracted softmax over the centers);
//   * the gradient of the Gaussian observation likelihood, which
//     `stein_loop` takes as its LikGrad parameter: the pendulum's is
//     hand-derived through one pendulum step, with the speed-clip gate and
//     the log-space chain rule (`lik_grad`, `PendulumLik`); the
//     cart-pole's is cartpole.cuh's;
//   * the RBF Stein direction in its folded drive form
//     phi_i = (sum_j k_ij (s_j - x_j/bw^2) + (sum_j k_ij) x_i/bw^2) / m;
//   * SGD: x_i += lr * phi_i.
// The arithmetic follows the plain PyTorch version
// (ops/mpf.py:stein_loop_plain, with the pendulum's gradient in
// pendulum_mpf_optimize_plain) operation by operation, the
// order of the sums over j too: lane l of a row's group walks the columns
// j = l, l + kLanes, ... in order and the group's partial sums meet in a
// fixed butterfly, for a quad (p0 + p1) + (p2 + p3)
// (ops/particle_mpf.py:lane_sum). The pairs' exps are one ex2.approx each
// with log2 e folded into the scale, within ~1e-6 relative of the plain
// version's exp. Two loops: `stein_loop_reg` (one row per group: K2 up to
// 64 particles with 8 lanes, K4/K5 and K14 at 49-52 with a quad) keeps
// each group's row, and each lane its squared distances to the centers,
// in registers; `stein_loop` walks particles and centers in shared memory
// (every other size). Both give the same bits for one lane count. Every
// thread of the block must call them (they synchronise the block).
//
// The skid-steer's episode kernel (K15, skid_steer_episode.cu) runs the
// same loops over particles of D = 3 values: `stein_loop_nd` and
// `stein_loop_reg_nd` through `episode_stein_loop_nd`, at the end of this
// header, the arithmetic above with a squared distance of D terms added
// in order (ops/mpf.py:stein_loop_plain takes any D). They sit beside the
// two-value loops rather than replacing them: one template over D for
// both changed K5's and K14's register allocation (ptxas: K14 123 -> 128
// registers, K5 16 -> 20 B of spill stores), though not their bits, and
// ran their sweeps 0.6-1.4% slower (PERF.md §6).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "stein.cuh"

namespace dust_mpf {

constexpr float kMaxSpeed = 8.0f;
constexpr float kMaxTorque = 2.0f;
constexpr float kPi = 3.14159265358979323846f;

// Lanes per particle row in K4/K5 and K14 (ops/mpf.py:EPISODE_ROW_LANES).
constexpr int kRowLanes = 4;
// The episode kernels' register loop: each lane holds kEpisodeRegCols
// columns or one fewer, so it serves kRowLanes * (kEpisodeRegCols - 1) < m
// <= kRowLanes * kEpisodeRegCols (49-52: the demos' 50;
// ops/mpf.py:EPISODE_REGISTER_MIN/MAX); the shared walk every other m.
// One instantiation: each further column count in the kernel cost the
// 50-particle step 3-6% through the kernel's registers (PERF.md §6).
constexpr int kEpisodeRegCols = 13;

// The phases of K2 that its clocked build times (ops/mpf.py:CLOCK_PHASES,
// phase_clock.cuh); the loops mark the two of an iteration.
enum : int { kClkLoad = 0, kClkPrior, kClkDrive, kClkStore, kClkPhases };

// The clock of the MPF loop inside the episode kernels: times nothing.
struct NoClock {
  __device__ __forceinline__ void mark(int) {}
};

using dust_solve::ex2;
using dust_solve::kLog2e;

// The constants of an MPF loop: the Stein step's (inv_pbw2, inv_bw2, cp,
// ck, lr, fm: all that a loop needs besides its likelihood gradient) and
// the pendulum likelihood's. theta0/theta_d0: the prediction start;
// loc0/loc1: the newest observation; half3g = 3 g 0.5.
struct MpfConsts {
  float inv_pbw2, inv_bw2, cp, ck, inv_s2, acts, sin_t, lr, fm;
  float theta0, theta_d0, loc0, loc1, dt, half3g;
  int log_space;
};

// The Stein step's constants of a loop over m particles with bandwidth bw
// and prior bandwidth pbw; the pendulum likelihood's fields stay unset.
__device__ __forceinline__ MpfConsts stein_consts(int m, float bw, float pbw,
                                                  float lr) {
  MpfConsts k;
  k.inv_pbw2 = 1.0f / (pbw * pbw);
  k.inv_bw2 = 1.0f / (bw * bw);
  // p_j = 2^(D_j cp - max), k_j = 2^(D_j ck), D the squared distance
  k.cp = -0.5f * k.inv_pbw2 * kLog2e;
  k.ck = -0.5f * k.inv_bw2 * kLog2e;
  k.lr = lr;
  k.fm = static_cast<float>(m);
  return k;
}

__device__ __forceinline__ MpfConsts mpf_consts(
    int m, float bw, float pbw, float lr, float sigma, float theta0,
    float theta_d0, float action, float loc0, float loc1, float dt,
    float half3g, int log_space) {
  MpfConsts k = stein_consts(m, bw, pbw, lr);
  k.inv_s2 = 1.0f / (sigma * sigma);
  k.acts = fminf(fmaxf(action, -kMaxTorque), kMaxTorque);
  k.sin_t = sinf(theta0 + kPi);
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

// lik_grad as stein_loop takes a likelihood gradient.
struct PendulumLik {
  const MpfConsts& k;
  __device__ __forceinline__ void operator()(float x0, float x1, float& gl0,
                                             float& gl1) const {
    lik_grad(x0, x1, k, gl0, gl1);
  }
};

// sx0/sx1: particles (updated in place); sc0/sc1: prior centers;
// st0/st1 and su0/su1: scratch for the drive terms (odd iterations take
// su); sn0/sn1: scratch for the new particles (the iterations alternate
// between sx and sn); all shared, m floats each. One block barrier per
// iteration: a row's group reads only its own new row before the next
// barrier, so a warp barrier orders it. Rows i = g, g + G, ... belong to
// group g of the block's G = blockDim.x / kLanes groups (blockDim.x a
// multiple of 32). k: the Stein step's constants (stein_consts); lik(x0,
// x1, gl0, gl1): the likelihood gradient of one particle (PendulumLik, or
// cartpole.cuh's CartPoleLik), called once per row and iteration. clk
// marks kClkPrior and kClkDrive each iteration.
template <int kLanes, class LikGrad, class Clock>
__device__ inline void stein_loop(float* sx0, float* sx1, const float* sc0,
                                  const float* sc1, float* st0, float* st1,
                                  float* sn0, float* sn1, float* su0,
                                  float* su1, int m, int n_steps,
                                  const MpfConsts& k, const LikGrad& lik,
                                  Clock& clk) {
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
      lik(x0, x1, gl_l, gl_m);
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

// The particles of `stein_loop_reg` in device memory: x_in, centers,
// x_out [m, 2] (K2); the centers held in registers.
struct PairIo {
  static constexpr bool kRegCenters = true;
  const float* __restrict__ x_in;
  const float* __restrict__ centers;
  float* __restrict__ x_out;
  __device__ __forceinline__ float2 row(int i) const {
    return make_float2(x_in[2 * i], x_in[2 * i + 1]);
  }
  __device__ __forceinline__ float2 center(int j) const {
    return make_float2(centers[2 * j], centers[2 * j + 1]);
  }
  __device__ __forceinline__ void store(int i, float x0, float x1) const {
    x_out[2 * i] = x0;
    x_out[2 * i + 1] = x1;
  }
};

// The particles of `stein_loop_reg` in the episode kernels' shared arrays
// x0 and x1 = x0 + m (8-byte aligned): the loop's start, which is also its
// centers (the loop writes them over x0/x1 as float2 for its duration),
// and its result. The caller puts a block barrier between the loop and
// the next read of x0/x1.
struct SplitIo {
  static constexpr bool kRegCenters = false;
  float* x0;
  float* x1;
  __device__ __forceinline__ float2 row(int i) const {
    return make_float2(x0[i], x1[i]);
  }
  __device__ __forceinline__ float2* centers() const {
    return reinterpret_cast<float2*>(x0);
  }
  __device__ __forceinline__ void store(int i, float v0, float v1) const {
    x0[i] = v0;
    x1[i] = v1;
  }
};

// The loop for m <= kLanes * kCols particles, one row per group (blockDim.x
// >= kLanes * m): row i = g is held in registers by its group's lanes, and
// lane l walks the columns j = l, l + kLanes, ... (at most kCols),
// keeping its squared distances to the centers from the max pass to the
// exp pass. The centers: with PairIo in the lane's registers, with
// SplitIo as float2 in shared memory (the particles at the start). The
// columns are unrolled branch-free, so that the loads and exps of a pass
// overlap: the first kSure are every lane's (m >= kLanes * kSure), at
// fixed offsets; a column past the lane's last reads column m - 1 and
// adds exactly zero (its exp takes -inf: ex2 gives +0). io: where the
// particles start (io.row) and where the result goes (io.store, after
// the last barrier). xt: 2 * m float4 of shared memory (16-byte aligned),
// each row's particle and drive term of two iterations in turn, so that
// the drive walk reads one float4 per column. One block barrier per
// iteration, between the prior score and the drive walk. lik as in
// stein_loop. The divisions by the row's prior weight sum and by m go
// through their reciprocals (stein.cuh:div_rn). The same bits as
// stein_loop<kLanes>.
template <int kLanes, int kCols, int kSure, class Io, class LikGrad,
          class Clock>
__device__ inline void stein_loop_reg(const Io& io, float4* xt, int m,
                                      int n_steps, const MpfConsts& k,
                                      const LikGrad& lik, Clock& clk) {
  static_assert(kSure <= kCols, "kSure: columns every lane has");
  using dust_solve::div_rn;
  using dust_solve::lane_group_sum;
  constexpr bool kRegCenters = Io::kRegCenters;
  const int i = threadIdx.x / kLanes;  // this group's row
  const int l = threadIdx.x % kLanes;
  const unsigned mask = dust_solve::lane_group_mask(kLanes);
  const bool row = i < m;
  const float inv_fm = 1.0f / k.fm;
  // unrolled column c is j = l + kLanes c where j < m, else m - 1; the
  // first kSure columns are every lane's (m >= kLanes * kSure)
  const auto col = [&](int c) {
    return c < kSure ? l + kLanes * c : min(l + kLanes * c, m - 1);
  };
  const auto real = [&](int c) { return c < kSure || l + kLanes * c < m; };
  float c0[kRegCenters ? kCols : 1], c1[kRegCenters ? kCols : 1];
  float dc[kCols];
  float x0 = 0.0f, x1 = 0.0f;
  if (row) {
    const float2 x = io.row(i);
    x0 = x.x;
    x1 = x.y;
  }
  float2* cs = nullptr;
  if constexpr (kRegCenters) {
    if (row) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float2 cj = io.center(col(c));
        c0[c] = cj.x;
        c1[c] = cj.y;
      }
    }
  } else {
    // the centers over the particles' own storage, once every row is read
    cs = io.centers();
    __syncthreads();
    if (row && l == 0) cs[i] = make_float2(x0, x1);
  }
  if (row && l == 0)
    reinterpret_cast<float2*>(xt + i)[0] = make_float2(x0, x1);
  if constexpr (!kRegCenters) __syncthreads();
  clk.mark(kClkLoad);

  for (int it = 0; it < n_steps; ++it) {
    float4* const xa = xt + (it & 1) * m;        // this iteration's
    float4* const xn = xt + ((it + 1) & 1) * m;  // the next one's
    if (row) {
      float gl_l, gl_m;
      lik(x0, x1, gl_l, gl_m);
      // ---- GMM prior score over the fixed centers ----
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        float2 cj;
        if constexpr (kRegCenters) {
          cj = make_float2(c0[c], c1[c]);
        } else {
          cj = cs[col(c)];
        }
        const float d0 = x0 - cj.x;
        const float d1 = x1 - cj.y;
        dc[c] = real(c) ? (d0 * d0 + d1 * d1) * k.cp : -INFINITY;
        mx = fmaxf(mx, dc[c]);
      }
      mx = dust_solve::lane_group_fmax<kLanes>(mx, mask);
      float psum = 0.0f, pc0 = 0.0f, pc1 = 0.0f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        float2 cj;
        if constexpr (kRegCenters) {
          cj = make_float2(c0[c], c1[c]);
        } else {
          cj = cs[col(c)];
        }
        const float p = ex2(dc[c] - mx);
        psum = psum + p;
        pc0 = pc0 + p * cj.x;
        pc1 = pc1 + p * cj.y;
      }
      psum = lane_group_sum<kLanes>(psum, mask);
      pc0 = lane_group_sum<kLanes>(pc0, mask);
      pc1 = lane_group_sum<kLanes>(pc1, mask);
      const float ips = 1.0f / psum;
      const float gp0 = (div_rn(pc0, psum, ips) - x0) * k.inv_pbw2;
      const float gp1 = (div_rn(pc1, psum, ips) - x1) * k.inv_pbw2;
      if (l == 0)
        reinterpret_cast<float2*>(xa + i)[1] =
            make_float2((gl_l + gp0) - x0 * k.inv_bw2,
                        (gl_m + gp1) - x1 * k.inv_bw2);
    }
    __syncthreads();
    clk.mark(kClkPrior);

    if (row) {
      // ---- RBF Stein direction, repulsion folded into the drive ----
      float rows = 0.0f, drive0 = 0.0f, drive1 = 0.0f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float4 q = xa[col(c)];  // x_j, then its drive term
        const float d0 = x0 - q.x;
        const float d1 = x1 - q.y;
        const float kk =
            ex2(real(c) ? (d0 * d0 + d1 * d1) * k.ck : -INFINITY);
        rows = rows + kk;
        drive0 = drive0 + kk * q.z;
        drive1 = drive1 + kk * q.w;
      }
      rows = lane_group_sum<kLanes>(rows, mask);
      drive0 = lane_group_sum<kLanes>(drive0, mask);
      drive1 = lane_group_sum<kLanes>(drive1, mask);
      x0 = x0 + k.lr * div_rn(drive0 + rows * x0 * k.inv_bw2, k.fm, inv_fm);
      x1 = x1 + k.lr * div_rn(drive1 + rows * x1 * k.inv_bw2, k.fm, inv_fm);
      // read by the other rows after the next iteration's barrier, which
      // this buffer's previous readers (the last iteration's walk) passed
      if (l == 0)
        reinterpret_cast<float2*>(xn + i)[0] = make_float2(x0, x1);
    }
    clk.mark(kClkDrive);
  }
  if (row && l == 0) io.store(i, x0, x1);
  clk.mark(kClkStore);
}

// The MPF loop of the episode kernels (K4/K5, K14) on their particles
// x0/x1 [m] in shared memory, which are also the centers and take the
// result: the register loop where m fits its columns (kEpisodeRegCols;
// blockDim.x >= kRowLanes * m), the shared walk otherwise. x0/x1: 2 m
// floats, 8-byte aligned; w: 8 m floats of shared scratch, 16-byte
// aligned (the register loop's float4 particles and drive terms; the
// shared walk's centers, drive terms and new particles). Ends with a
// block barrier.
template <class LikGrad>
__device__ inline void episode_stein_loop(float* x0, float* x1, float* w,
                                          int m, int n_steps,
                                          const MpfConsts& k,
                                          const LikGrad& lik) {
  NoClock clk;
  if (m > kRowLanes * (kEpisodeRegCols - 1) &&
      m <= kRowLanes * kEpisodeRegCols) {
    stein_loop_reg<kRowLanes, kEpisodeRegCols, kEpisodeRegCols - 1>(
        SplitIo{x0, x1}, reinterpret_cast<float4*>(w), m, n_steps, k, lik,
        clk);
    __syncthreads();
  } else {
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      w[i] = x0[i];
      w[m + i] = x1[i];
    }
    __syncthreads();
    stein_loop<kRowLanes>(x0, x1, w, w + m, w + 2 * m, w + 3 * m, w + 4 * m,
                          w + 5 * m, w + 6 * m, w + 7 * m, m, n_steps, k, lik,
                          clk);
  }
}

// -- the loops over D values a particle (K15: D = 3) -------------------------

// D shared arrays of m floats, one per value of a particle, laid one after
// another from p[0].
template <int D>
struct Cols {
  float* p[D];
};

// The squared distance between x and c, its D terms added in order.
template <int D>
__device__ __forceinline__ float dist2(const float (&x)[D],
                                       const float (&c)[D]) {
  float d = x[0] - c[0];
  float s = d * d;
#pragma unroll
  for (int e = 1; e < D; ++e) {
    d = x[e] - c[e];
    s = s + d * d;
  }
  return s;
}

// `stein_loop` over D values a particle: sx, sc, st, sn, su as there, D
// arrays each; lik(x, gl) the likelihood gradient gl[D] of one particle
// x[D] (skid_steer.cuh's SkidLik).
template <int kLanes, int D, class LikGrad, class Clock>
__device__ inline void stein_loop_nd(Cols<D> sx, Cols<D> sc, Cols<D> st,
                                     Cols<D> sn, Cols<D> su, int m,
                                     int n_steps, const MpfConsts& k,
                                     const LikGrad& lik, Clock& clk) {
  using dust_solve::lane_group_sum;
  const int g = threadIdx.x / kLanes;
  const int l = threadIdx.x % kLanes;
  const int groups = blockDim.x / kLanes;
  const unsigned mask = dust_solve::lane_group_mask(kLanes);
  Cols<D> xs = sx;  // this iteration's particles
  Cols<D> ns = sn;  // the next iteration's

  for (int it = 0; it < n_steps; ++it) {
    const Cols<D> ts = it & 1 ? su : st;  // this iteration's drive terms
    for (int i = g; i < m; i += groups) {
      float x[D], gl[D];
#pragma unroll
      for (int e = 0; e < D; ++e) x[e] = xs.p[e][i];
      lik(x, gl);
      // ---- GMM prior score over the fixed centers ----
      float psum = 0.0f, pc[D];
#pragma unroll
      for (int e = 0; e < D; ++e) pc[e] = 0.0f;
      float mx = -INFINITY;
#pragma unroll 4
      for (int j = l; j < m; j += kLanes) {
        float c[D];
#pragma unroll
        for (int e = 0; e < D; ++e) c[e] = sc.p[e][j];
        mx = fmaxf(mx, dist2<D>(x, c) * k.cp);
      }
      mx = dust_solve::lane_group_fmax<kLanes>(mx, mask);
#pragma unroll 4
      for (int j = l; j < m; j += kLanes) {
        float c[D];
#pragma unroll
        for (int e = 0; e < D; ++e) c[e] = sc.p[e][j];
        const float p = ex2(dist2<D>(x, c) * k.cp - mx);
        psum = psum + p;
#pragma unroll
        for (int e = 0; e < D; ++e) pc[e] = pc[e] + p * c[e];
      }
      psum = lane_group_sum<kLanes>(psum, mask);
#pragma unroll
      for (int e = 0; e < D; ++e) pc[e] = lane_group_sum<kLanes>(pc[e], mask);
      if (l == 0) {
#pragma unroll
        for (int e = 0; e < D; ++e) {
          const float gp = (pc[e] / psum - x[e]) * k.inv_pbw2;
          ts.p[e][i] = (gl[e] + gp) - x[e] * k.inv_bw2;
        }
      }
    }
    __syncthreads();
    clk.mark(kClkPrior);

    for (int i = g; i < m; i += groups) {
      // ---- RBF Stein direction, repulsion folded into the drive ----
      float x[D], drive[D];
#pragma unroll
      for (int e = 0; e < D; ++e) {
        x[e] = xs.p[e][i];
        drive[e] = 0.0f;
      }
      float rows = 0.0f;
#pragma unroll 4
      for (int j = l; j < m; j += kLanes) {
        float xj[D];
#pragma unroll
        for (int e = 0; e < D; ++e) xj[e] = xs.p[e][j];
        const float kk = ex2(dist2<D>(x, xj) * k.ck);
        rows = rows + kk;
#pragma unroll
        for (int e = 0; e < D; ++e) drive[e] = drive[e] + kk * ts.p[e][j];
      }
      rows = lane_group_sum<kLanes>(rows, mask);
#pragma unroll
      for (int e = 0; e < D; ++e)
        drive[e] = lane_group_sum<kLanes>(drive[e], mask);
      if (l == 0) {
#pragma unroll
        for (int e = 0; e < D; ++e)
          ns.p[e][i] =
              x[e] + k.lr * ((drive[e] + rows * x[e] * k.inv_bw2) / k.fm);
      }
    }
    // no block barrier, as in stein_loop
    __syncwarp();
    clk.mark(kClkDrive);
    const Cols<D> t = xs;
    xs = ns;
    ns = t;
  }
  __syncthreads();
  if (xs.p[0] != sx.p[0]) {  // an odd count of iterations ended in sn
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
#pragma unroll
      for (int e = 0; e < D; ++e) sx.p[e][i] = xs.p[e][i];
    }
    __syncthreads();
  }
}

// float4 per row of `stein_loop_reg_nd`'s xt: a particle's D values, then
// its drive term's D
template <int D>
constexpr int kRowF4 = (2 * D + 3) / 4;

// The loop for m <= kLanes * kCols particles of D values, as
// `stein_loop_reg` with SplitIo: x the particles (D m floats from x.p[0],
// the loop's start, centers and result: the centers written over them,
// center j's D values together, for its duration); xt: 2 * m * kRowF4<D>
// float4 of shared memory (16-byte aligned), each row's particle and
// drive term of two iterations in turn. The same bits as
// stein_loop_nd<kLanes, D>.
template <int kLanes, int kCols, int kSure, int D, class LikGrad,
          class Clock>
__device__ inline void stein_loop_reg_nd(Cols<D> x_io, float4* xt, int m,
                                         int n_steps, const MpfConsts& k,
                                         const LikGrad& lik, Clock& clk) {
  static_assert(kSure <= kCols, "kSure: columns every lane has");
  using dust_solve::div_rn;
  using dust_solve::lane_group_sum;
  constexpr int kF4 = kRowF4<D>;
  const int i = threadIdx.x / kLanes;  // this group's row
  const int l = threadIdx.x % kLanes;
  const unsigned mask = dust_solve::lane_group_mask(kLanes);
  const bool row = i < m;
  const float inv_fm = 1.0f / k.fm;
  // unrolled column c is j = l + kLanes c where j < m, else m - 1; the
  // first kSure columns are every lane's (m >= kLanes * kSure)
  const auto col = [&](int c) {
    return c < kSure ? l + kLanes * c : min(l + kLanes * c, m - 1);
  };
  const auto real = [&](int c) { return c < kSure || l + kLanes * c < m; };
  float* const cs = x_io.p[0];  // the centers, [m, D]
  // row r of xt: its particle's D values, then its drive term's
  const auto xrow = [&](float4* base, int r) {
    return reinterpret_cast<float*>(base + kF4 * r);
  };
  float dc[kCols];
  float x[D];
#pragma unroll
  for (int e = 0; e < D; ++e) x[e] = row ? x_io.p[e][i] : 0.0f;
  // the centers over the particles' own storage, once every row is read
  __syncthreads();
  if (row && l == 0) {
    float* f = xrow(xt, i);
#pragma unroll
    for (int e = 0; e < D; ++e) {
      cs[D * i + e] = x[e];
      f[e] = x[e];
    }
  }
  __syncthreads();
  clk.mark(kClkLoad);

  for (int it = 0; it < n_steps; ++it) {
    float4* const xa = xt + (it & 1) * m * kF4;        // this iteration's
    float4* const xn = xt + ((it + 1) & 1) * m * kF4;  // the next one's
    if (row) {
      float gl[D];
      lik(x, gl);
      // ---- GMM prior score over the fixed centers ----
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        float cj[D];
#pragma unroll
        for (int e = 0; e < D; ++e) cj[e] = cs[D * col(c) + e];
        dc[c] = real(c) ? dist2<D>(x, cj) * k.cp : -INFINITY;
        mx = fmaxf(mx, dc[c]);
      }
      mx = dust_solve::lane_group_fmax<kLanes>(mx, mask);
      float psum = 0.0f, pc[D];
#pragma unroll
      for (int e = 0; e < D; ++e) pc[e] = 0.0f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float p = ex2(dc[c] - mx);
        psum = psum + p;
#pragma unroll
        for (int e = 0; e < D; ++e) pc[e] = pc[e] + p * cs[D * col(c) + e];
      }
      psum = lane_group_sum<kLanes>(psum, mask);
#pragma unroll
      for (int e = 0; e < D; ++e) pc[e] = lane_group_sum<kLanes>(pc[e], mask);
      const float ips = 1.0f / psum;
      if (l == 0) {
        float* f = xrow(xa, i);
#pragma unroll
        for (int e = 0; e < D; ++e) {
          const float gp = (div_rn(pc[e], psum, ips) - x[e]) * k.inv_pbw2;
          f[D + e] = (gl[e] + gp) - x[e] * k.inv_bw2;
        }
      }
    }
    __syncthreads();
    clk.mark(kClkPrior);

    if (row) {
      // ---- RBF Stein direction, repulsion folded into the drive ----
      float rows = 0.0f, drive[D];
#pragma unroll
      for (int e = 0; e < D; ++e) drive[e] = 0.0f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        // x_j, then its drive term, kF4 float4 loads
        float f[4 * kF4];
        const float4* q = xa + kF4 * col(c);
#pragma unroll
        for (int r = 0; r < kF4; ++r) {
          const float4 v = q[r];
          f[4 * r] = v.x;
          f[4 * r + 1] = v.y;
          f[4 * r + 2] = v.z;
          f[4 * r + 3] = v.w;
        }
        float xj[D];
#pragma unroll
        for (int e = 0; e < D; ++e) xj[e] = f[e];
        const float kk =
            ex2(real(c) ? dist2<D>(x, xj) * k.ck : -INFINITY);
        rows = rows + kk;
#pragma unroll
        for (int e = 0; e < D; ++e) drive[e] = drive[e] + kk * f[D + e];
      }
      rows = lane_group_sum<kLanes>(rows, mask);
#pragma unroll
      for (int e = 0; e < D; ++e)
        drive[e] = lane_group_sum<kLanes>(drive[e], mask);
#pragma unroll
      for (int e = 0; e < D; ++e)
        x[e] = x[e] + k.lr * div_rn(drive[e] + rows * x[e] * k.inv_bw2,
                                    k.fm, inv_fm);
      // read by the other rows after the next iteration's barrier, which
      // this buffer's previous readers (the last iteration's walk) passed
      if (l == 0) {
        float* f = xrow(xn, i);
#pragma unroll
        for (int e = 0; e < D; ++e) f[e] = x[e];
      }
    }
    clk.mark(kClkDrive);
  }
  if (row && l == 0) {
#pragma unroll
    for (int e = 0; e < D; ++e) x_io.p[e][i] = x[e];
  }
  clk.mark(kClkStore);
}

// Floats of `episode_stein_loop_nd`'s shared scratch per particle: the
// register loop's float4 rows of two iterations, or the shared walk's
// centers, drive terms (two) and new particles, whichever is larger.
template <int D>
constexpr int kEpisodeScratch =
    8 * kRowF4<D> > 4 * D ? 8 * kRowF4<D> : 4 * D;

// `episode_stein_loop` over D values a particle (K15): the register loop
// at the same particle counts (49-52; ops/mpf.py:episode_register_loop),
// the shared walk otherwise. x: D m floats from x.p[0], 8-byte aligned;
// w: kEpisodeScratch<D> m floats of shared scratch, 16-byte aligned. Ends
// with a block barrier.
template <int D, class LikGrad>
__device__ inline void episode_stein_loop_nd(Cols<D> x, float* w, int m,
                                             int n_steps,
                                             const MpfConsts& k,
                                             const LikGrad& lik) {
  NoClock clk;
  if (m > kRowLanes * (kEpisodeRegCols - 1) &&
      m <= kRowLanes * kEpisodeRegCols) {
    stein_loop_reg_nd<kRowLanes, kEpisodeRegCols, kEpisodeRegCols - 1>(
        x, reinterpret_cast<float4*>(w), m, n_steps, k, lik, clk);
    __syncthreads();
  } else {
    Cols<D> sc, st, sn, su;
#pragma unroll
    for (int e = 0; e < D; ++e) {
      sc.p[e] = w + e * m;
      st.p[e] = w + (D + e) * m;
      sn.p[e] = w + (2 * D + e) * m;
      su.p[e] = w + (3 * D + e) * m;
    }
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
#pragma unroll
      for (int e = 0; e < D; ++e) sc.p[e][i] = x.p[e][i];
    }
    __syncthreads();
    stein_loop_nd<kRowLanes, D>(x, sc, st, sn, su, m, n_steps, k, lik, clk);
  }
}

}  // namespace dust_mpf
