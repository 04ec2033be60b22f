// Whole skid-steer navigation DuSt episodes in one launch (K15), one block
// per (group, chain, scenario) episode. The port's own kernel: the JAX
// package has no skid-steer episode kernel.
//
// Each of `steps` iterations: action noise and parameter draws (drawn by
// the counter-based generator) -> Silverman bandwidth of the policy
// particles -> (x_icr, wheel_radius, axial_distance) draws from the live
// MPF prior -> the n_params x m x n_act rollouts of the kinematic step and
// navigation cost through the occupancy map (skid_steer.cuh) -> DISCO
// weights, the delta and likelihood gradient, the Stein step and forward
// (stein.cuh) -> warm-up gate of the action, the plans and the
// weighted-prior refresh -> the simulator step with the episode's true
// parameters (x_icr times load_scale from step load_step on), crash
// freeze, the state frozen once done -> the MPF bandwidth and Stein loop
// over the three-value particles (pendulum_mpf.cuh:episode_stein_loop_nd,
// K5/K14's loop at D = 3, on skid_steer.cuh's likelihood gradient), gated
// on step >= warm_up and not done -> cost, crash and goal detection
// against the pre-step done -> one log row (x, y, theta, v, omega, the two
// wheel speeds, cost, done, crashed, bw_sv, bw_mpf).
//
// Design, as K10's (particle_episode.cu), whose plans (two values a
// horizon step), map (particle.cuh's model array and occupancy bits) and
// SVMPC phases it repeats: one persistent block of 256 threads per
// episode keeps every piece of state in shared memory for the whole
// episode, two blocks per SM (<= 128 registers), so each episode computes
// what a launch of it alone computes, bit for bit. The 1,536
// trajectories of a step (4 draws x 6 plans x 64 samples) take one thread
// each in turn, six full rounds of 256, each pair's draws summed
// afterwards in draw order (stein.cuh:sum_draws); each trajectory step's
// sin/cos of the heading in cartpole_math.cuh's branch-free form (K14's),
// the library's bits, the library's sincosf past its range (counted in
// `fallbacks`). The DISCO delta takes 8 lanes per entry, the MPF loop a
// quad of lanes per particle, its row in registers at 49-52 particles
// (8% faster a call than the shared walk, PERF.md §6), the Silverman
// bandwidths their order statistics from a bitonic sort in shared memory
// (stein.cuh:silverman_sorted). The per-step noise lives in device
// memory, read one step ahead of the chain.

#include <cuda_runtime.h>
#include <stdint.h>

#include "counter_rng.cuh"
#include "particle.cuh"
#include "pendulum_mpf.cuh"
#include "phase_clock.cuh"
#include "skid_steer.cuh"
#include "stein.cuh"

namespace {

using namespace dust_solve;
using dust_particle::kModelFloats;
namespace dp = dust_particle;
namespace dk = dust_skid;

struct EpisodeArgs {
  const float* model;   // ops/particle_rollout.py:model_tensor
  const float* scal;    // [14] ops/skid_steer_episode.py:skid_steer_scal
  const float* ep_f;    // [B, 3] true x_icr, wheel_radius, axial_distance
  const int* ep_i;      // [B, 3] seed0, seed1, scenario
  const float* logmix0; // [m]
  const float* theta0;
  const float* locs0;
  const float* amat0;   // [B, m, hz * 2]
  const float* mpfx0;   // [B, m_mpf, 3]
  float* eps;           // [B, 2 hz m n_act]: each step's action noise
  float* log;           // [B, steps, kLogFields]
  float* theta_out;
  float* locs_out;
  float* amat_out;      // [B, m, hz * 2]
  float* mpfx_out;      // [B, m_mpf, 3]
  long long* clock;     // [B, kClockSlots] (the clocked build), or null
  unsigned long long* fallbacks;  // [1] the rollouts' fallbacks, or null
  int steps, warm_up, hz, m, n_params, n_act, m_mpf, mpf_steps, load_step;
  float lo, hi, load_scale, success_dist2, log_n_act;
  int exp_util, weighted_prior, log_space, fixed_bw;
  float mpf_fixed_bw, mpf_bw_scale;
};

constexpr int kDim = 3;  // values of an MPF particle
constexpr int kLogFields = 12;
// lanes that share one entry's sum over the action samples in the DISCO
// delta (ops/skid_steer_episode.py:SUM_LANES)
constexpr int kSumLanes = 8;
// The phases of one step that the clocked build times, K5's
// (ops/skid_steer_episode.py:CLOCK_PHASES, phase_clock.cuh).
enum : int {
  kClkNoise = 0, kClkSilverman, kClkDraws, kClkRollouts, kClkDisco,
  kClkDelta, kClkStein, kClkCommit, kClkMpfBw, kClkMpf, kClkLog,
  kClkPhases,
  kClockSlots = kClkPhases + 2
};

// simulator and step scalars in shared memory
enum : int {
  kX = 0,                            // simulator state [5]
  kLik = 5,                          // the MPF likelihood's observation [5]
  kNew = 10,                         // the new state [5]
  kDone = 15, kCrashed, kPriorBw,
  kAr, kAl,                          // the action taken
  kScalars = 24                      // the last slot holds i_star
};

// the smallest power of two >= n: the Silverman sort's length
__host__ __device__ inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// the floats before the MPF block, rounded up to a multiple of 4 so that
// its float4 scratch is 16-byte aligned
constexpr int kFixed = (kModelFloats + 3 * kMaxM * kMaxM + 6 * kMaxM +
                        (4 + kDim + 1) * kMaxParams + 2 * kWarps + 8 +
                        kScalars + 3) / 4 * 4;

__host__ __device__ inline size_t episode_smem_floats(int m, int ev,
                                                      int n_act, int m_mpf,
                                                      int n_params) {
  const int mh = m * ev;
  const int n_sort = kDim * m_mpf > mh ? kDim * m_mpf : mh;
  return kFixed +
         static_cast<size_t>(dust_mpf::kEpisodeScratch<kDim> + kDim) *
             m_mpf +
         5 * static_cast<size_t>(mh) +
         (3 + static_cast<size_t>(n_params)) * m * n_act +
         pow2_at_least(n_sort);
}

template <bool kClock>
__global__ void __launch_bounds__(kThreads, 2)
    skid_steer_episode_kernel(EpisodeArgs a) {
  extern __shared__ __align__(16) float sh[];
  __shared__ long long clk_acc[kClkPhases];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int m = a.m, hz = a.hz, n_act = a.n_act, n_params = a.n_params;
  const int m_mpf = a.m_mpf;
  const int ev = 2 * hz;
  const int mh = m * ev;
  const int ma = m * n_act;
  const int n_eps = 2 * hz * ma;

  // the arrays of fixed size first, at constant offsets; then the MPF
  // block, its float4 scratch 16-byte aligned; then the policy arrays
  float* km = sh;
  SteinSmem ss;
  ss.lp = km + kModelFloats;
  ss.r = ss.lp + kMaxM * kMaxM;
  ss.kmat = ss.r + kMaxM * kMaxM;
  ss.rowsum = ss.kmat + kMaxM * kMaxM;
  ss.log_w = ss.rowsum + kMaxM;
  ss.weights = ss.log_w + kMaxM;
  float* eta = ss.weights + kMaxM;
  float* log_l = eta + kMaxM;
  float* logmix = log_l + kMaxM;      // prior mixture log-weights
  float* dxicr = logmix + kMaxM;      // the draws' x_icr,
  float* drad = dxicr + kMaxParams;   // wheel radius,
  float* dbase = drad + kMaxParams;   // axial distance
  float* dib = dbase + kMaxParams;    // and its reciprocal
  float* pdz = dib + kMaxParams;      // [n_params, kDim]
  float* pdu = pdz + kDim * kMaxParams;
  float* red = pdu + kMaxParams;      // 2 * kWarps + 8
  float* sv = red + 2 * kWarps + 8;   // [kScalars]
  ss.i_star = reinterpret_cast<int*>(sv + kScalars - 1);
  float* mpf_w = sh + kFixed;         // MPF scratch
  float* sx = mpf_w + dust_mpf::kEpisodeScratch<kDim> * m_mpf;  // [kDim, m]
  float* theta = sx + kDim * m_mpf;
  float* locs = theta + mh;
  float* amat = locs + mh;
  float* score = amat + mh;
  float* theta_new = score + mh;
  float* mcost = theta_new + mh;
  float* omega = mcost + ma;
  float* w_lik = omega + ma;
  float* dcost = w_lik + ma;          // [n_params, m * n_act] draw costs
  float* srt = dcost + n_params * ma; // the Silverman sort
  const int n_sort = pow2_at_least(mh);
  const int n_sort_mpf = pow2_at_least(kDim * m_mpf);
  const SilvermanN sv_n = silverman_n(mh);
  const SilvermanN mpf_n = silverman_n(kDim * m_mpf);

  // scal: [x0, y0, th0, v0, w0, ctrl_sigma, lr, alpha, inv_temp, inv_s2,
  //        inv_ps2, mpf_lr, mpf_sigma, prior_bw0]
  const float* sc = a.scal;
  const float sigma_c = sc[5], lr = sc[6], inv_s2 = sc[9], inv_ps2 = sc[10];
  const float mpf_lr = sc[11], mpf_sigma = sc[12];
  const DiscoConsts dkc{sc[8], sc[7], a.log_n_act,
                        static_cast<float>(1.0 / n_act), a.exp_util};
  const float xicr_true = a.ep_f[3 * b], r_true = a.ep_f[3 * b + 1];
  const float b_true = a.ep_f[3 * b + 2];
  const uint32_t seed0 = static_cast<uint32_t>(a.ep_i[3 * b]);
  const uint32_t seed1 = static_cast<uint32_t>(a.ep_i[3 * b + 1]);
  const uint32_t scen = static_cast<uint32_t>(a.ep_i[3 * b + 2]);
  const dust_mpf::Cols<kDim> mpf_x{{sx, sx + m_mpf, sx + 2 * m_mpf}};

  for (int e = tid; e < mh; e += nt) {
    theta[e] = a.theta0[b * mh + e];
    locs[e] = a.locs0[b * mh + e];
    amat[e] = a.amat0[b * mh + e];
  }
  for (int i = tid; i < m_mpf; i += nt) {
#pragma unroll
    for (int d = 0; d < kDim; ++d)
      sx[d * m_mpf + i] = a.mpfx0[(b * m_mpf + i) * kDim + d];
  }
  if (tid < m) logmix[tid] = a.logmix0[tid];
  if (tid == 0) {
    for (int k = 0; k < 5; ++k) {
      sv[kX + k] = sc[k];
      sv[kLik + k] = sc[k];
    }
    sv[kDone] = 0.0f;
    sv[kCrashed] = 0.0f;
    sv[kPriorBw] = sc[13];
  }
  dp::load_model(a.model, km);  // synchronises the block
  const float dt = km[dp::kDt];
  const bool crash = km[dp::kCrash] != 0.0f;
  const float lo = a.lo, hi = a.hi;

  dust_clock::PhaseClock<kClock, kClkPhases> clk(clk_acc);

  for (int step = 0; step < a.steps; ++step) {
    // ---- noise: eps [2, hz, m, n_act], draws pdz [n_params, 3], pdu ----
    float* eps = a.eps + static_cast<size_t>(b) * n_eps;
    {
      const uint32_t key = dust_rng::rng_key(seed0, seed1, step, scen);
      for (int e = tid; e < n_eps; e += nt)
        eps[e] = dust_rng::normal_at(key, e);
      if (tid < kDim * n_params)
        pdz[tid] = dust_rng::normal_at(key, n_eps + tid);
      if (tid < n_params)
        pdu[tid] = dust_rng::uniform_at(
            key, 2u * (n_eps + kDim * n_params) + tid);
    }
    __syncthreads();
    clk.mark(kClkNoise);
    const bool active = step >= a.warm_up;
    // the MPF gate: step >= warm_up and not done before this step
    const bool gate = active && sv[kDone] <= 0.5f;

    // ---- Silverman bandwidth of the policy particles ----
    const float bw_sv = silverman_sorted(theta, sv_n, n_sort, srt, red);
    clk.mark(kClkSilverman);

    // ---- (x_icr, wheel_radius, axial_distance) draws from the live MPF
    // prior ----
    const float prior_bw = sv[kPriorBw];
    if (tid < n_params) {
      const float fi = fminf(floorf(pdu[tid] * static_cast<float>(m_mpf)),
                             static_cast<float>(m_mpf - 1));
      const int idx = max(0, min(static_cast<int>(fi), m_mpf - 1));
      float d[kDim];
#pragma unroll
      for (int k = 0; k < kDim; ++k) {
        d[k] = sx[k * m_mpf + idx] + prior_bw * pdz[kDim * tid + k];
        if (a.log_space) d[k] = expf(d[k]);
      }
      dxicr[tid] = d[0];
      drad[tid] = d[1];
      dbase[tid] = d[2];
      dib[tid] = 1.0f / d[2];
    }
    __syncthreads();
    clk.mark(kClkDraws);

    // ---- rollouts + costs: one (draw, particle, sample) trajectory per
    // thread in turn, a = theta + sigma eps, the noise read one step ahead
    // of the chain; then each pair's draws summed in draw order ----
    for (int u = tid; u < n_params * ma; u += nt) {
      const int p = u / ma;
      const int pair = u - p * ma;
      const int q = pair / n_act;
      const int i = pair - q * n_act;
      const float* ep = eps + q * n_act + i;
      const float* th = theta + q * ev;
      dcost[u] = dk::trajectory_cost(
          km, lo, hi, sv + kX, dk::Draw{dxicr[p], drad[p], dbase[p], dib[p]},
          hz,
          [&](int t) {
            return make_float2(ep[t * ma], ep[(hz + t) * ma]);
          },
          [&](int t, float2 e, float& ar, float& al) {
            ar = th[2 * t] + sigma_c * e.x;
            al = th[2 * t + 1] + sigma_c * e.y;
          },
          a.fallbacks);
    }
    __syncthreads();
    sum_draws(dcost, n_params, ma, mcost);
    __syncthreads();
    clk.mark(kClkRollouts);
    disco_weights(mcost, m, n_act, dkc, omega, w_lik, eta, log_l, red);
    clk.mark(kClkDisco);

    // ---- DISCO delta (a_seq is zero) and likelihood gradient: kSumLanes
    // lanes per entry, lane s taking the samples i = s, s + kSumLanes, ...
    // (reads of neighbouring noise values), then a butterfly in a fixed
    // order ----
    {
      const int sub = tid % kSumLanes;
      const unsigned mask = lane_group_mask(kSumLanes);
      for (int e = tid / kSumLanes; e < mh; e += nt / kSumLanes) {
        const int q = e / ev;
        const int l = e - q * ev;
        const float th = theta[e];
        const float* ep = eps + (((l & 1) * hz + (l >> 1)) * m + q) * n_act;
        float d = 0.0f, wa = 0.0f;
        for (int i = sub; i < n_act; i += kSumLanes) {
          const float av = th + sigma_c * ep[i];
          d = d + omega[q * n_act + i] * av;
          wa = wa + w_lik[q * n_act + i] * av;
        }
        d = lane_group_sum<kSumLanes>(d, mask);
        wa = lane_group_sum<kSumLanes>(wa, mask);
        if (sub == 0) {
          amat[e] = amat[e] + d;
          score[e] = (wa - th) * inv_s2;
        }
      }
    }
    __syncthreads();
    clk.mark(kClkDelta);

    // ---- Stein step + forward ----
    stein_forward(theta, locs, score, logmix, 1, log_l, m, ev, bw_sv, lr,
                  inv_ps2, ss, theta_new);
    clk.mark(kClkStein);

    // ---- warm-up gate + commits ----
    const int star = *ss.i_star;
    for (int e = tid; e < mh; e += nt) {
      const int l = e % ev;
      const float fwd = l < ev - 2 ? theta_new[e + 2] : theta_new[e];
      theta[e] = active ? fwd : theta_new[e];
      if (active) locs[e] = fwd;
    }
    if (tid == 0) {
      const float af = active ? 1.0f : 0.0f;
      const float a_r = af * (star < m ? theta_new[star * ev] : 0.0f);
      const float a_l = af * (star < m ? theta_new[star * ev + 1] : 0.0f);
      if (a.weighted_prior && active) {
        // logmix = log_softmax(log(max(weights, 1e-37)))
        float lmax = -INFINITY;
        for (int q = 0; q < m; ++q) {
          logmix[q] = logf(maxp(ss.weights[q], 1e-37f));
          lmax = maxp(lmax, logmix[q]);
        }
        float se = 0.0f;
        for (int q = 0; q < m; ++q) se = se + expf(logmix[q] - lmax);
        const float lse = lmax + logf(se);
        for (int q = 0; q < m; ++q) logmix[q] = logmix[q] - lse;
      }
      // ---- simulator: the kinematic step with the true parameters, the
      // load on x_icr, crash freeze, frozen once done ----
      const float xicr =
          step >= a.load_step ? xicr_true * a.load_scale : xicr_true;
      const float s_scale =
          crash ? dt * (1.0f - dp::occupancy(km, sv[kX], sv[kX + 1])) : dt;
      float x = sv[kX], y = sv[kX + 1], th = sv[kX + 2];
      float v, w, s, c;
      dk::speeds(a_r, a_l, lo, hi, r_true, b_true, 1.0f / b_true, v, w);
      sincosf(th, &s, &c);
      dk::advance(x, y, th, v, w, s, c, s_scale, xicr);
      const bool frozen = sv[kDone] > 0.5f;
      const float nw[5] = {x, y, th, v, w};
      for (int k = 0; k < 5; ++k)
        sv[kNew + k] = frozen ? sv[kX + k] : nw[k];
      sv[kAr] = a_r;
      sv[kAl] = a_l;
    }
    clk.mark(kClkCommit);
    // ---- MPF update, gated on step >= warm_up and not done: Silverman
    // bandwidth of the flattened particles (or the fixed one), then the
    // Stein loop centered on them with the previous bandwidth ----
    const float bw_mpf =
        a.fixed_bw ? a.mpf_fixed_bw
                   : silverman_sorted(sx, mpf_n, n_sort_mpf, srt, red) *
                         a.mpf_bw_scale;
    __syncthreads();
    clk.mark(kClkMpfBw);
    if (gate) {
      const float mscale =
          crash ? dt * (1.0f - dp::occupancy(km, sv[kLik], sv[kLik + 1]))
                : dt;
      const dk::SkidLik lik(sv + kLik, sv[kAr], sv[kAl], sv + kNew, lo, hi,
                            mscale, mpf_sigma, a.log_space);
      dust_mpf::episode_stein_loop_nd<kDim>(
          mpf_x, mpf_w, m_mpf, a.mpf_steps,
          dust_mpf::stein_consts(m_mpf, bw_mpf, prior_bw, mpf_lr), lik);
    }
    clk.mark(kClkMpf);
    if (tid == 0) {
      if (gate) {
        sv[kPriorBw] = bw_mpf;
        for (int k = 0; k < 5; ++k) sv[kLik + k] = sv[kNew + k];
      }
      // ---- cost, then crash / goal detection against the pre-step done
      const float nx = sv[kNew], ny = sv[kNew + 1], nv = sv[kNew + 3];
      const float nwv = sv[kNew + 4];
      const float done0 = sv[kDone];
      const float occ_n = dp::occupancy(km, nx, ny);
      const float cost =
          dp::state_cost(km, km + dp::kWpx, nx, ny, nv, nwv, occ_n);
      const float dx = nx - km[dp::kTx], dy = ny - km[dp::kTy];
      const float dv = nv - km[dp::kTvx], dw = nwv - km[dp::kTvy];
      float dist2 = dx * dx;
      dist2 = dist2 + dy * dy;
      dist2 = dist2 + dv * dv;
      dist2 = dist2 + dw * dw;
      const bool crash_now = occ_n > 0.0f;
      const bool success_now = dist2 <= a.success_dist2;
      const float crashed =
          maxp(sv[kCrashed], (crash_now && done0 < 0.5f) ? 1.0f : 0.0f);
      const float done = maxp(done0, (crash_now || success_now) ? 1.0f : 0.0f);
      float* row = a.log + (static_cast<size_t>(b) * a.steps + step) *
                               kLogFields;
      for (int k = 0; k < 5; ++k) row[k] = sv[kNew + k];
      row[5] = sv[kAr];
      row[6] = sv[kAl];
      row[7] = cost;
      row[8] = done;
      row[9] = crashed;
      row[10] = bw_sv;
      row[11] = bw_mpf;
      for (int k = 0; k < 5; ++k) sv[kX + k] = sv[kNew + k];
      sv[kDone] = done;
      sv[kCrashed] = crashed;
    }
    __syncthreads();
    clk.mark(kClkLog);
  }
  clk.write(a.clock + static_cast<size_t>(b) * kClockSlots);

  for (int e = tid; e < mh; e += nt) {
    a.theta_out[b * mh + e] = theta[e];
    a.locs_out[b * mh + e] = locs[e];
    a.amat_out[b * mh + e] = amat[e];
  }
  for (int i = tid; i < m_mpf; i += nt) {
#pragma unroll
    for (int d = 0; d < kDim; ++d)
      a.mpfx_out[(b * m_mpf + i) * kDim + d] = sx[d * m_mpf + i];
  }
}

template <bool kClock>
int launch(int B, const EpisodeArgs& a, cudaStream_t stream) {
  if (B < 1 || a.m < 1 || a.m > kMaxM || a.n_params < 1 ||
      a.n_params > kMaxParams || a.m_mpf < 1 ||
      a.m_mpf * dust_mpf::kRowLanes > kThreads || a.hz < 1 || a.n_act < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes =
      episode_smem_floats(a.m, 2 * a.hz, a.n_act, a.m_mpf, a.n_params) *
      sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        skid_steer_episode_kernel<kClock>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  skid_steer_episode_kernel<kClock><<<B, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// B episodes, one block each. Arguments: see EpisodeArgs. Device pointers,
// float32 (ep_i int32), contiguous; eps is scratch the kernel writes each
// step's noise to. lo, hi: the wheel speeds' bounds; success_dist2 =
// success_dist^2 and log_n_act = log(n_act), folded by the caller. clock,
// when not null, is [B, kClockSlots] int64: the launch then takes the
// build of the kernel that times the phases of a step (the other build has
// no clock code). fallbacks, when not null, is one int64 that each
// rollout step taking the library's sincosf adds 1 to
// (skid_steer.cuh:step).
extern "C" int dust_skid_steer_episodes(
    const float* model, const float* scal, const float* ep_f, const int* ep_i,
    const float* logmix0, const float* theta0, const float* locs0,
    const float* amat0, const float* mpfx0, float* eps, float* log,
    float* theta_out, float* locs_out, float* amat_out, float* mpfx_out,
    long long* clock, unsigned long long* fallbacks, int B, int steps,
    int warm_up, int hz, int m, int n_params, int n_act, int m_mpf,
    int mpf_steps, int load_step, float lo, float hi, float load_scale,
    float success_dist2, float log_n_act, int exp_util, int weighted_prior,
    int log_space, int fixed_bw, float mpf_fixed_bw, float mpf_bw_scale,
    void* stream) {
  const EpisodeArgs a{model, scal, ep_f, ep_i, logmix0, theta0, locs0,
                      amat0, mpfx0, eps, log, theta_out, locs_out, amat_out,
                      mpfx_out, clock, fallbacks, steps, warm_up, hz, m,
                      n_params, n_act, m_mpf, mpf_steps, load_step, lo, hi,
                      load_scale, success_dist2, log_n_act, exp_util,
                      weighted_prior, log_space, fixed_bw, mpf_fixed_bw,
                      mpf_bw_scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return clock != nullptr ? launch<true>(B, a, s) : launch<false>(B, a, s);
}
