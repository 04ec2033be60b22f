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

// sin/cos of the rotation angle x = om * dt, |x| <= xmax
// (ops/episode.py:rot_sincos)
__device__ __forceinline__ void rot_sincos(float x, float xmax, float& s,
                                           float& c) {
  if (xmax > 1.0f) {
    s = sinf(x);
    c = cosf(x);
    return;
  }
  const float x2 = x * x;
  if (xmax <= 0.5f) {
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

// Constants of the rollout, folded on the host in double precision:
// cg = -3 g 0.5 dt, ca = 3 dt, xmax = 8 dt.
struct RolloutConsts {
  float dt, xmax, cg, ca;
};

// Param-averaged swing-up cost of every (particle q, action sample i)
// pair into mcost[q * n_act + i]. One thread per pair holds the states of
// all n_params draws in registers (independent chains). act(q, i, t)
// returns the unclipped action; il/im: 1/length, 1/mass per draw.
template <class Act>
__device__ inline void rollout_mcost(float th0, float om0, const float* il,
                              const float* im, int n_params, int m, int hz,
                              int n_act, const RolloutConsts& k, Act act,
                              float* mcost) {
  const float c0 = cosf(th0);
  const float s0 = sinf(th0);
  const float inv_np = static_cast<float>(1.0 / n_params);
  for (int pair = threadIdx.x; pair < m * n_act; pair += blockDim.x) {
    const int q = pair / n_act;
    const int i = pair - q * n_act;
    float c[kMaxParams], s[kMaxParams], om[kMaxParams], cost[kMaxParams];
    float cg[kMaxParams], ca[kMaxParams];
#pragma unroll
    for (int p = 0; p < kMaxParams; ++p) {
      if (p < n_params) {
        cg[p] = k.cg * il[p];
        ca[p] = k.ca * im[p] * il[p] * il[p];
        c[p] = c0;
        s[p] = s0;
        om[p] = om0;
        cost[p] = 0.0f;
      }
    }
    for (int t = 0; t < hz; ++t) {
      const float a = clampf(act(q, i, t), -kMaxTorque, kMaxTorque);
#pragma unroll
      for (int p = 0; p < kMaxParams; ++p) {
        if (p < n_params) {
          const float d = c[p] - 1.0f;
          cost[p] = cost[p] + kSwingW * (d * d);
          cost[p] = cost[p] + om[p] * om[p];
          float o = om[p] + cg[p] * (-s[p]);
          o = o + ca[p] * a;
          o = clampf(o, -kMaxSpeed, kMaxSpeed);
          float sd, cd;
          rot_sincos(o * k.dt, k.xmax, sd, cd);
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
    for (int p = 0; p < kMaxParams; ++p) {
      if (p < n_params) {
        const float d = c[p] - 1.0f;
        float cp = cost[p] + kSwingW * (d * d);
        cp = cp + om[p] * om[p];
        mc = p == 0 ? cp : mc + cp;
      }
    }
    mcost[pair] = mc * inv_np;
  }
}

}  // namespace dust_solve
