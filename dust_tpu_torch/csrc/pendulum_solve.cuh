// Block-level device code of one pendulum SVMPC solve, shared by the
// whole-solve kernel (K3, pendulum_solve.cu) and the whole-episode kernel
// (K4/K5, pendulum_episode.cu): the pendulum rollout costs. The rest of
// the solve (softmaxes, Stein step, forward, Silverman) is stein.cuh.
//
// The arithmetic follows the plain PyTorch versions (ops/solve.py,
// ops/episode.py) operation by operation (see stein.cuh).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "stein.cuh"

namespace dust_solve {

constexpr float kMaxSpeed = 8.0f;
constexpr float kMaxTorque = 2.0f;
constexpr float kSwingW = 50.0f;

// sin/cos of the rotation angle x = om * dt, |x| <= xmax, by the range of
// xmax (ops/episode.py:rot_sincos): kRot 0 exact trig (xmax > 1), 1 the
// short Taylor polynomials (xmax <= 0.5), 2 the longer ones.
template <int kRot>
__device__ __forceinline__ void rot_sincos(float x, float& s, float& c) {
  if constexpr (kRot == 0) {
    s = sinf(x);
    c = cosf(x);
  } else {
    const float x2 = x * x;
    if constexpr (kRot == 1) {
      s = x * (1.0f + x2 * (static_cast<float>(-1.0 / 6.0) +
                            x2 * (static_cast<float>(1.0 / 120.0) -
                                  x2 * static_cast<float>(1.0 / 5040.0))));
      c = 1.0f + x2 * (-0.5f + x2 * (static_cast<float>(1.0 / 24.0) -
                                     x2 * static_cast<float>(1.0 / 720.0)));
    } else {
      s = x * (1.0f +
               x2 * (static_cast<float>(-1.0 / 6.0) +
                     x2 * (static_cast<float>(1.0 / 120.0) +
                           x2 * (static_cast<float>(-1.0 / 5040.0) +
                                 x2 * static_cast<float>(1.0 / 362880.0)))));
      c = 1.0f +
          x2 * (-0.5f + x2 * (static_cast<float>(1.0 / 24.0) +
                              x2 * (static_cast<float>(-1.0 / 720.0) +
                                    x2 * static_cast<float>(1.0 / 40320.0))));
    }
  }
}

// Constants of the rollout, folded on the host in double precision:
// cg = -3 g 0.5 dt, ca = 3 dt, xmax = 8 dt.
struct RolloutConsts {
  float dt, xmax, cg, ca;
};

// Param-averaged swing-up cost of the (particle q, action sample i) pairs
// pair = q * n_act + i in [p_begin, p_end) into mcost[pair] (a cluster's
// block takes a share of the pairs). One thread per pair holds the states of
// all n_params draws in registers (independent chains) and adds their
// costs in draw order. ld(q, i, t) returns the raw value behind step t's
// action, act(q, t, raw) the unclipped action; ld is called one step ahead
// of the chains, so a read's latency overlaps a step. il/im: 1/length,
// 1/mass per draw. kRot is the rotation's range (rot_sincos); kFull:
// n_params == kMaxParams. Both are fixed before the loop, so a step of the
// chains has no branch.
template <int kRot, bool kFull, class Load, class Act>
__device__ inline void rollout_pairs(float th0, float om0, const float* il,
                                     const float* im, int n_params,
                                     int p_begin, int p_end, int hz,
                                     int n_act, const RolloutConsts& k,
                                     Load ld, Act act, float* mcost) {
  constexpr int kP = kMaxParams;
  const float c0 = cosf(th0);
  const float s0 = sinf(th0);
  const float inv_np = static_cast<float>(1.0 / n_params);
  for (int pair = p_begin + threadIdx.x; pair < p_end;
       pair += blockDim.x) {
    const int q = pair / n_act;
    const int i = pair - q * n_act;
    float c[kP], s[kP], om[kP], cost[kP], cg[kP], ca[kP];
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      if (kFull || p < n_params) {
        cg[p] = k.cg * il[p];
        ca[p] = k.ca * im[p] * il[p] * il[p];
        c[p] = c0;
        s[p] = s0;
        om[p] = om0;
        cost[p] = 0.0f;
      }
    }
    float raw = ld(q, i, 0);
    for (int t = 0; t < hz; ++t) {
      const float a = clampf(act(q, t, raw), -kMaxTorque, kMaxTorque);
      if (t + 1 < hz) raw = ld(q, i, t + 1);
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        if (kFull || p < n_params) {
          const float d = c[p] - 1.0f;
          cost[p] = cost[p] + kSwingW * (d * d);
          cost[p] = cost[p] + om[p] * om[p];
          float o = om[p] + cg[p] * (-s[p]);
          o = o + ca[p] * a;
          o = clampf(o, -kMaxSpeed, kMaxSpeed);
          float sd, cd;
          rot_sincos<kRot>(o * k.dt, sd, cd);
          const float cn = c[p] * cd - s[p] * sd;
          const float sn = s[p] * cd + c[p] * sd;
          c[p] = cn;
          s[p] = sn;
          om[p] = o;
        }
      }
    }
    float mc = 0.0f;
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      if (kFull || p < n_params) {
        const float d = c[p] - 1.0f;
        float cp = cost[p] + kSwingW * (d * d);
        cp = cp + om[p] * om[p];
        mc = p == 0 ? cp : mc + cp;
      }
    }
    mcost[pair] = mc * inv_np;
  }
}

// rollout_pairs with kRot and kFull chosen from the run's values.
template <class Load, class Act>
__device__ inline void rollout_mcost(float th0, float om0, const float* il,
                                     const float* im, int n_params,
                                     int p_begin, int p_end, int hz,
                                     int n_act, const RolloutConsts& k,
                                     Load ld, Act act, float* mcost) {
#define DUST_ROLLOUT(ROT, FULL)                                          \
  rollout_pairs<ROT, FULL>(th0, om0, il, im, n_params, p_begin, p_end, hz, \
                           n_act, k, ld, act, mcost)
  const bool full = n_params == kMaxParams;
  if (k.xmax > 1.0f) {
    if (full) DUST_ROLLOUT(0, true); else DUST_ROLLOUT(0, false);
  } else if (k.xmax <= 0.5f) {
    if (full) DUST_ROLLOUT(1, true); else DUST_ROLLOUT(1, false);
  } else {
    if (full) DUST_ROLLOUT(2, true); else DUST_ROLLOUT(2, false);
  }
#undef DUST_ROLLOUT
}

}  // namespace dust_solve
