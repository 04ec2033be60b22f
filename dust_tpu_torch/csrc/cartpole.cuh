// The cart-pole as block-level device code for the whole-episode kernel
// (K14, cartpole_episode.cu): the step of models/cartpole.py (Barto,
// Sutton & Anderson's cart-pole with cart and pole friction, total mass
// m_c + m_p), the swing-up cost, the param-averaged rollout costs and the
// gradient of the MPF's Gaussian observation likelihood with respect to
// (length, mass_pole), derived by hand.
//
// The arithmetic follows the plain PyTorch version (ops/cartpole_episode.py)
// operation by operation (the library is built with --fmad=false, sin/cos
// and the divisions at full precision); a division by a value fixed over a
// rollout (the total mass, the pole's mass times its length) takes its
// reciprocal and one corrected product (stein.cuh:div_rn), equal to the
// division. The rollouts take their sin/cos and th_dd's division in the
// branch-free forms of cartpole_math.cuh, which give the library's bits
// inside a tested range; a chunk-step whose chains leave it is recomputed
// with the library's sincosf and `/`, so the bits are the library's on
// both sides.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "cartpole_math.cuh"
#include "stein.cuh"

namespace dust_cartpole {

using dust_solve::clampf;
using dust_solve::div_rn;

constexpr float kFourThirds = static_cast<float>(4.0 / 3.0);
// the swing-up cost (ops/cartpole_episode.py:state_cost): 50 (cos th -
// 1)^2 + th_dot^2 + x^2 + 0.1 x_dot^2, plus 1e3 off the track |x| > 2.4
constexpr float kAngleW = 50.0f;
constexpr float kCartVelW = 0.1f;
constexpr float kTrack = 2.4f;
constexpr float kTrackCost = 1000.0f;

// The model's constants (models/cartpole.py's defaults by default).
struct Model {
  float g, mc, mu_c, mu_p, f_mag, dt;
};

__device__ __forceinline__ float state_cost(float x, float xd, float c,
                                            float thd) {
  const float d = c - 1.0f;
  float v = kAngleW * (d * d);
  v = v + thd * thd;
  v = v + x * x;
  v = v + kCartVelW * (xd * xd);
  return v + (fabsf(x) > kTrack ? kTrackCost : 0.0f);
}

// torch.sign: 0 at 0 and at NaN.
__device__ __forceinline__ float sign0(float v) {
  return v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : 0.0f);
}

// The terms of the accelerations at cart speed xd, s = sin th, c = cos th,
// pole speed thd, force f, under the parameters (l, mp) with M = mc + mp,
// pm = mp l and their reciprocals iM, ipm: th_dd = num / den, and factor,
// which x_dd takes (cart_accel).
__device__ __forceinline__ void accel_terms(const Model& k, float xd, float s,
                                            float c, float thd, float f,
                                            float l, float mp, float M,
                                            float iM, float pm, float ipm,
                                            float& factor, float& num,
                                            float& den) {
  const float cf = k.mu_c * sign0(xd);
  const float pf = div_rn(k.mu_p * thd, pm, ipm);
  factor = div_rn((f + (pm * s) * (thd * thd)) - cf, M, iM);
  num = ((k.g * s) - (c * factor)) - pf;
  den = l * (kFourThirds - div_rn(mp * (c * c), M, iM));
}

__device__ __forceinline__ float cart_accel(float factor, float tdd, float c,
                                            float pm, float M, float iM) {
  return factor - div_rn((pm * tdd) * c, M, iM);
}

// The accelerations (x_dd, th_dd), as accel_terms takes its arguments.
__device__ __forceinline__ void accel(const Model& k, float xd, float s,
                                      float c, float thd, float f, float l,
                                      float mp, float M, float iM, float pm,
                                      float ipm, float& xdd, float& tdd) {
  float factor, num, den;
  accel_terms(k, xd, s, c, thd, f, l, mp, M, iM, pm, ipm, factor, num, den);
  tdd = num / den;
  xdd = cart_accel(factor, tdd, c, pm, M, iM);
}

// One rollout chain's terms of a step from (x, xd, th, thd) under force f:
// c = cos th, the state's cost sc, factor and th_dd. kFast: sin/cos and the
// division in cartpole_math.cuh's forms, returning whether they hold there
// (the library's bits); else the library's sincosf and `/`.
template <bool kFast>
__device__ __forceinline__ bool step_terms(const Model& k, float x, float xd,
                                           float th, float thd, float f,
                                           float l, float mp, float M,
                                           float iM, float pm, float ipm,
                                           float& c, float& sc,
                                           float& factor, float& tdd) {
  float s, num, den;
  if (kFast)
    fast_sincosf(th, s, c);
  else
    sincosf(th, &s, &c);
  sc = state_cost(x, xd, c, thd);
  accel_terms(k, xd, s, c, thd, f, l, mp, M, iM, pm, ipm, factor, num, den);
  if (!kFast) {
    tdd = num / den;
    return true;
  }
  tdd = fast_div(num, den);
  return trig_ok(th) & div_ok(num, den);
}

// Adds 1 for each thread that calls it to *n (when not null), one atomic
// per warp's group of threads that call it together.
__device__ __forceinline__ void count_threads(unsigned long long* n) {
  if (n == nullptr) return;
  const unsigned mask = __activemask();
  if ((threadIdx.x & 31) == __ffs(mask) - 1)
    atomicAdd(n, static_cast<unsigned long long>(__popc(mask)));
}

// Param-averaged swing-up cost of the (particle q, action sample i) pairs
// pair = q * n_act + i into mcost[pair], one thread per pair: the draws'
// chains advance kC at a time, interleaved in registers, and their costs
// add in draw order. s0: the state [4]; lens/mps: the draws' (length,
// mass_pole); ld(q, i, t) returns the raw value behind step t's action,
// act(q, t, raw) the action before its clamp; ld is called one step ahead
// of the chains.
//
// Each step of the kC chains (a chunk-step) runs branch-free: step_terms'
// fast forms for every chain, then one test of their ranges; where it
// fails, the chunk-step is recomputed from the same state with the
// library's sincosf and `/`, and counted in *fallbacks (when not null).
// The final cosine of a chunk is tested and counted alike. A chain past
// the last draw repeats it, and its cost is not added.
template <int kC, class Load, class Act>
__device__ inline void rollout_mcost(const float* s0, const float* lens,
                                     const float* mps, int n_params, int m,
                                     int hz, int n_act, const Model& k,
                                     Load ld, Act act, float* mcost,
                                     unsigned long long* fallbacks) {
  const float inv_np = static_cast<float>(1.0 / n_params);
  const int n = m * n_act;
  for (int pair = threadIdx.x; pair < n; pair += blockDim.x) {
    const int q = pair / n_act;
    const int i = pair - q * n_act;
    float mc = 0.0f;
    for (int p0 = 0; p0 < n_params; p0 += kC) {
      float x[kC], xd[kC], th[kC], thd[kC], cost[kC];
      float L[kC], MP[kC], M[kC], iM[kC], pm[kC], ipm[kC];
#pragma unroll
      for (int p = 0; p < kC; ++p) {
        const int d = min(p0 + p, n_params - 1);
        L[p] = lens[d];
        MP[p] = mps[d];
        M[p] = k.mc + MP[p];
        iM[p] = 1.0f / M[p];
        pm[p] = MP[p] * L[p];
        ipm[p] = 1.0f / pm[p];
        x[p] = s0[0];
        xd[p] = s0[1];
        th[p] = s0[2];
        thd[p] = s0[3];
        cost[p] = 0.0f;
      }
      float raw = ld(q, i, 0);
      for (int t = 0; t < hz; ++t) {
        const float f = clampf(act(q, t, raw), -1.0f, 1.0f) * k.f_mag;
        if (t + 1 < hz) raw = ld(q, i, t + 1);
        float c[kC], sc[kC], fac[kC], tdd[kC];
        bool fast = true;
#pragma unroll
        for (int p = 0; p < kC; ++p)
          fast &= step_terms<true>(k, x[p], xd[p], th[p], thd[p], f, L[p],
                                   MP[p], M[p], iM[p], pm[p], ipm[p], c[p],
                                   sc[p], fac[p], tdd[p]);
        if (!fast) {
#pragma unroll
          for (int p = 0; p < kC; ++p)
            step_terms<false>(k, x[p], xd[p], th[p], thd[p], f, L[p], MP[p],
                              M[p], iM[p], pm[p], ipm[p], c[p], sc[p],
                              fac[p], tdd[p]);
          count_threads(fallbacks);
        }
#pragma unroll
        for (int p = 0; p < kC; ++p) {
          const float xdd = cart_accel(fac[p], tdd[p], c[p], pm[p], M[p],
                                       iM[p]);
          cost[p] = cost[p] + sc[p];
          x[p] = x[p] + xd[p] * k.dt;
          xd[p] = xd[p] + xdd * k.dt;
          th[p] = th[p] + thd[p] * k.dt;
          thd[p] = thd[p] + tdd[p] * k.dt;
        }
      }
      float c[kC];
      bool fast = true;
#pragma unroll
      for (int p = 0; p < kC; ++p) {
        float s;
        fast_sincosf(th[p], s, c[p]);
        fast &= trig_ok(th[p]);
      }
      if (!fast) {
#pragma unroll
        for (int p = 0; p < kC; ++p) c[p] = cosf(th[p]);
        count_threads(fallbacks);
      }
#pragma unroll
      for (int p = 0; p < kC; ++p) {
        if (p0 + p < n_params) {
          const float cp = cost[p] + state_cost(x[p], xd[p], c[p], thd[p]);
          mc = p0 + p == 0 ? cp : mc + cp;
        }
      }
    }
    mcost[pair] = mc * inv_np;
  }
}

// The gradient of the MPF's Gaussian observation log-likelihood of one
// transition, -|f(s0, a; l, mp) - s1|^2 / (2 sigma^2), with respect to a
// particle (l, mp) (in log space with respect to their logs): only the
// predicted speeds x_dot + x_dd dt and th_dot + th_dd dt depend on the
// parameters. The chain, for p in (l, mp), with factor = (f + pm s w^2 -
// cf) / M, num = g s - c factor - pf, q = 4/3 - mp c^2 / M, den = l q:
//   dfactor/dl = mp s w^2 / M,  dfactor/dmp = (l s w^2 - factor) / M,
//   dpf/dl = -pf / l,  dpf/dmp = -pf / mp,
//   dnum/dp = -c dfactor/dp - dpf/dp,
//   dden/dl = q,  dden/dmp = -l c^2 mc / M^2,
//   dth_dd/dp = (dnum/dp - th_dd dden/dp) / den,
//   dx_dd/dl = dfactor/dl - (mp c / M) (th_dd + l dth_dd/dl),
//   dx_dd/dmp = dfactor/dmp - l c (mc / M^2 th_dd + mp / M dth_dd/dmp).
// Constants of one MPF update: the transition's start (x_dot, th_dot, sin
// and cos of th, the clamped force) and end speeds.
struct CartPoleLik {
  Model k;
  float f, cf, sn, cs, w2, gsn, cc, mpthd;
  float xd0, thd0, xd1, thd1, inv_s2;
  int log_space;

  __device__ CartPoleLik(const Model& model, const float* s0, float action,
                         const float* s1, float sigma, int log_space_)
      : k(model), log_space(log_space_) {
    f = clampf(action, -1.0f, 1.0f) * k.f_mag;
    cf = k.mu_c * sign0(s0[1]);
    float s, c;
    sincosf(s0[2], &s, &c);
    sn = s;
    cs = c;
    xd0 = s0[1];
    thd0 = s0[3];
    w2 = thd0 * thd0;
    gsn = k.g * sn;
    cc = cs * cs;
    mpthd = k.mu_p * thd0;
    xd1 = s1[1];
    thd1 = s1[3];
    inv_s2 = 1.0f / (sigma * sigma);
  }

  __device__ __forceinline__ void operator()(float x0, float x1, float& gl_l,
                                             float& gl_m) const {
    float l = x0;
    float mp = x1;
    if (log_space) {
      l = expf(l);
      mp = expf(mp);
    }
    // ---- the predicted speeds (the model's step) ----
    const float M = k.mc + mp;
    const float pm = mp * l;
    const float pf = mpthd / pm;
    const float factor = ((f + (pm * sn) * w2) - cf) / M;
    const float num = (gsn - (cs * factor)) - pf;
    const float q = kFourThirds - (mp * cc) / M;
    const float den = l * q;
    const float tdd = num / den;
    const float xdd = factor - ((pm * tdd) * cs) / M;
    const float r_xd = (xd0 + xdd * k.dt) - xd1;
    const float r_thd = (thd0 + tdd * k.dt) - thd1;
    // ---- their derivatives ----
    const float iM = 1.0f / M;
    const float il = 1.0f / l;
    const float imp = 1.0f / mp;
    const float iden = 1.0f / den;
    const float snw2 = sn * w2;
    const float dfac_dl = (mp * snw2) * iM;
    const float dfac_dm = ((l * snw2) - factor) * iM;
    const float dnum_dl = (pf * il) - (cs * dfac_dl);
    const float dnum_dm = (pf * imp) - (cs * dfac_dm);
    const float iM2 = iM * iM;
    const float dden_dm = l * (-(cc * k.mc) * iM2);
    const float dtdd_dl = (dnum_dl - tdd * q) * iden;
    const float dtdd_dm = (dnum_dm - tdd * dden_dm) * iden;
    const float dxdd_dl = dfac_dl - ((mp * cs) * iM) * (tdd + l * dtdd_dl);
    const float dxdd_dm =
        dfac_dm - (l * cs) * ((k.mc * iM2) * tdd + (mp * iM) * dtdd_dm);
    const float cx = -(r_xd * k.dt) * inv_s2;
    const float ct = -(r_thd * k.dt) * inv_s2;
    gl_l = cx * dxdd_dl + ct * dtdd_dl;
    gl_m = cx * dxdd_dm + ct * dtdd_dm;
    if (log_space) {
      gl_l = gl_l * l;
      gl_m = gl_m * mp;
    }
  }
};

}  // namespace dust_cartpole
