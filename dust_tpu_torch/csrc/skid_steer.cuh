// The skid-steer robot on the particle task's obstacle course as device
// code for its whole-episode kernel (K15, skid_steer_episode.cu): the
// kinematic step of models/skid_steer.py (the four-wheel skid-steer of
// Kozlowski & Pazderski 2004, upstream lubaroli/dust
// dust/models/skid_steer_robot.py), with the particle's crash freeze, the
// navigation cost over (x, y) and (v, omega), one rollout's cost, and the
// gradient of the MPF's Gaussian observation likelihood with respect to
// the three uncertain parameters (x_icr, wheel_radius, axial_distance),
// derived by hand.
//
// The state is [x, y, theta, v, omega]; the action the right and left
// wheel speeds, each clamped to [lo, hi]. Under the parameters (x_icr, r,
// b) one step of length dt from (x, y, theta) is
//   v = (R + L) pi r,  omega = (R - L) 2 pi r / b,
//   fwd = v dt,  lat = -omega x_icr dt,
//   x' = x + fwd cos theta - lat sin theta,
//   y' = y + fwd sin theta + lat cos theta,  theta' = theta + omega dt,
// with dt times (1 - occupancy of (x, y)) where the course can crash (the
// particle's freeze: a robot inside an obstacle cell stays in place). The
// map and the cost's weights and target live in particle.cuh's model array
// (ops/particle_rollout.py:model_tensor): its (px, py, vx, vy) slots hold
// (x, y, v, omega), and the map is read at the skid-steer's own cell size.
//
// The arithmetic follows the plain PyTorch version
// (ops/skid_steer_episode.py) operation by operation (the library is built
// with --fmad=false). The division by b takes its reciprocal and one
// corrected product (stein.cuh:div_rn), equal to the division. The
// rollouts take sin/cos of the heading in cartpole_math.cuh's branch-free
// form, the library's bits where |theta| < 105615, which one test a step
// checks; past it the step recomputes them with the library's sincosf and
// counts the fallback.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "cartpole.cuh"  // cartpole_math.cuh's forms, count_threads
#include "particle.cuh"
#include "stein.cuh"

namespace dust_skid {

using dust_solve::clampf;
using dust_solve::div_rn;
namespace dp = dust_particle;

// math.pi in float32, as torch multiplies a float32 tensor by it
constexpr float kPi = 3.14159265358979323846f;

// One draw of the parameters: x_icr, the wheel radius r, the axial
// distance b and its reciprocal.
struct Draw {
  float xicr, r, b, ib;
};

// The speeds (v, omega) under wheel speeds (ar, al), each clamped to
// [lo, hi], and the parameters r, b (ib = 1 / b).
__device__ __forceinline__ void speeds(float ar, float al, float lo, float hi,
                                       float r, float b, float ib, float& v,
                                       float& w) {
  const float R = clampf(ar, lo, hi);
  const float L = clampf(al, lo, hi);
  v = ((R + L) * kPi) * r;
  w = div_rn((((R - L) * 2.0f) * kPi) * r, b, ib);
}

// The pose after a step of speeds (v, w) with sin / cos (s, c) of the
// heading, over `scale` (dt, or dt (1 - occupancy)) and x_icr.
__device__ __forceinline__ void advance(float& x, float& y, float& th,
                                        float v, float w, float s, float c,
                                        float scale, float xicr) {
  const float fwd = v * scale;
  const float lat = ((-w) * xicr) * scale;
  x = (x + fwd * c) - lat * s;
  y = (y + fwd * s) + lat * c;
  th = th + w * scale;
}

// The running cost of (s_t, a_t) and the step of one rollout under draw d;
// a heading past cartpole_math.cuh's range takes the library's sincosf,
// counted in *fallbacks (when not null).
__device__ __forceinline__ float step(const float* km, float lo, float hi,
                                      float& x, float& y, float& th, float& v,
                                      float& w, float ar, float al,
                                      const Draw& d,
                                      unsigned long long* fallbacks) {
  const float occ = dp::occupancy(km, x, y);
  float cost = dp::state_cost(km, km + dp::kWpx, x, y, v, w, occ);
  cost = cost + km[dp::kWcx] * ar * ar;
  cost = cost + km[dp::kWcy] * al * al;
  const float scale =
      km[dp::kCrash] != 0.0f ? km[dp::kDt] * (1.0f - occ) : km[dp::kDt];
  float s, c;
  dust_cartpole::fast_sincosf(th, s, c);
  if (!dust_cartpole::trig_ok(th)) {
    sincosf(th, &s, &c);
    dust_cartpole::count_threads(fallbacks);
  }
  speeds(ar, al, lo, hi, d.r, d.b, d.ib, v, w);
  advance(x, y, th, v, w, s, c, scale, d.xicr);
  return cost;
}

// The navigation cost of one trajectory of draw d from the state s0[5]:
// the running costs in step order, then the terminal cost. ld(t) returns
// the raw values behind step t's action, act(t, raw, ar, al) makes the
// action from them; ld is called one step ahead of the chain (as
// particle.cuh:trajectory_cost).
template <class Load, class Act>
__device__ __forceinline__ float trajectory_cost(
    const float* km, float lo, float hi, const float* s0, const Draw& d,
    int hz, Load ld, Act act, unsigned long long* fallbacks) {
  float x = s0[0], y = s0[1], th = s0[2], v = s0[3], w = s0[4];
  float cost = 0.0f;
  float2 raw = ld(0);
  for (int t = 0; t < hz; ++t) {
    float ar, al;
    act(t, raw, ar, al);
    if (t + 1 < hz) raw = ld(t + 1);
    cost = cost + step(km, lo, hi, x, y, th, v, w, ar, al, d, fallbacks);
  }
  return cost + dp::terminal_cost(km, x, y, v, w);
}

// The gradient of the MPF's Gaussian observation log-likelihood of one
// transition s0 -> s1 under the wheel speeds (ar, al),
// -|f(s0, a; x_icr, r, b) - s1|^2 / (2 sigma^2), with respect to a
// particle (x_icr, r, b) (in log space with respect to their logs). Every
// value of the predicted state depends on the parameters but theta's
// sine and cosine, which are the start's. With e the prediction's error,
// ea = e_x cos th + e_y sin th and eb = e_y cos th - e_x sin th (the
// error along and across the heading), S = (R + L) pi and Dq = (R - L) 2
// pi:
//   dv/dr = S,  domega/dr = Dq / b,  domega/db = -omega / b,
//   dfwd/dr = S dt,  dlat/dp = -(domega/dp) x_icr dt (p = r, b),
//   dlat/dx_icr = -omega dt,
//   d(x', y')/dp . (e_x, e_y) = dfwd/dp ea + dlat/dp eb,
//   dtheta'/dp = domega/dp dt,
// and the gradient is -(1 / sigma^2) times the sum of each value's error
// times its derivative; dt is the step's (times the crash factor at s0).
struct SkidLik {
  float sq, dq, sn, cs, scale, inv_s2;
  float x0, y0, th0, x1, y1, th1, v1, w1;
  int log_space;

  // s0, s1: [5] states; scale: dt, or dt (1 - occupancy of s0).
  __device__ SkidLik(const float* s0, float ar, float al, const float* s1,
                     float lo, float hi, float scale_, float sigma,
                     int log_space_)
      : scale(scale_), log_space(log_space_) {
    const float R = clampf(ar, lo, hi);
    const float L = clampf(al, lo, hi);
    sq = (R + L) * kPi;
    dq = ((R - L) * 2.0f) * kPi;
    float s, c;
    sincosf(s0[2], &s, &c);
    sn = s;
    cs = c;
    x0 = s0[0];
    y0 = s0[1];
    th0 = s0[2];
    x1 = s1[0];
    y1 = s1[1];
    th1 = s1[2];
    v1 = s1[3];
    w1 = s1[4];
    inv_s2 = 1.0f / (sigma * sigma);
  }

  __device__ __forceinline__ void operator()(const float (&p)[3],
                                             float (&gl)[3]) const {
    float xicr = p[0], r = p[1], b = p[2];
    if (log_space) {
      xicr = expf(xicr);
      r = expf(r);
      b = expf(b);
    }
    // ---- the predicted state (the model's step) ----
    const float v = sq * r;
    const float w = (dq * r) / b;
    float x = x0, y = y0, th = th0;
    advance(x, y, th, v, w, sn, cs, scale, xicr);
    const float ex = x - x1;
    const float ey = y - y1;
    const float eth = th - th1;
    const float ev = v - v1;
    const float ew = w - w1;
    // ---- its derivatives ----
    const float ea = ex * cs + ey * sn;
    const float eb = ey * cs - ex * sn;
    const float ib = 1.0f / b;
    const float dw_dr = dq * ib;
    const float dw_db = -(w * ib);
    const float dlat_dx = (-w) * scale;
    const float dlat_dr = ((-dw_dr) * xicr) * scale;
    const float dlat_db = ((-dw_db) * xicr) * scale;
    const float dfwd_dr = sq * scale;
    const float g_x = dlat_dx * eb;
    float g_r = dfwd_dr * ea + dlat_dr * eb;
    g_r = g_r + eth * (dw_dr * scale);
    g_r = g_r + ev * sq;
    g_r = g_r + ew * dw_dr;
    float g_b = dlat_db * eb + eth * (dw_db * scale);
    g_b = g_b + ew * dw_db;
    gl[0] = -(g_x * inv_s2);
    gl[1] = -(g_r * inv_s2);
    gl[2] = -(g_b * inv_s2);
    if (log_space) {
      gl[0] = gl[0] * xicr;
      gl[1] = gl[1] * r;
      gl[2] = gl[2] * b;
    }
  }
};

}  // namespace dust_skid
