// Whole cart-pole DuSt swing-up episodes in one launch (K14), one block
// per (group, chain, scenario) episode, as K5 runs the pendulum's. The
// port's own kernel: the JAX package has no cart-pole episode kernel.
//
// Each of `steps` iterations: action noise and parameter draws (drawn by
// the counter-based generator) -> Silverman
// bandwidth of the policy particles -> (length, mass_pole) draws from the
// live MPF prior -> the n_params x m x n_act rollouts of the cart-pole
// step and swing-up cost (cartpole.cuh) -> DISCO weights, the delta and
// likelihood gradient in the theta + sigma * sum(w eps) form, the Stein
// step and forward (stein.cuh) -> commit -> the simulator
// step with the episode's true parameters (the pole mass times
// load_scale from step load_step on) -> Silverman bandwidth of the MPF
// particles and the MPF Stein loop (pendulum_mpf.cuh:episode_stein_loop,
// K4/K5's, on the cart-pole's likelihood gradient) -> one log row
// (x, x_dot, th, th_dot, action, cost, bw_sv, bw_mpf).
//
// Design, as K5's (pendulum_episode.cu): one persistent block of 256
// threads per episode keeps every piece of state in shared memory for the
// whole episode, two blocks per SM (<= 128 registers), so each episode
// computes what a launch of it alone computes, bit for bit, and a
// diverged one cannot reach another. The rollouts hold a pair's chains in
// registers, four draws at a time (the cart-pole's state is 4 values and
// each draw keeps 6 constants: eight at a time spilled past K5's budget),
// each step of the four branch-free: sin/cos and th_dd's division in
// cartpole_math.cuh's forms, the library's bits inside the range one test
// per step checks, the library's sincosf and `/` past it (counted in
// `fallbacks`), so ptxas interleaves the four chains;
// the DISCO delta takes 8 lanes per entry; the MPF loop a quad of lanes
// per particle, its row in registers at 49-52 particles (K5's loop). The
// per-step noise lives in device memory, read through L1/L2.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cartpole.cuh"
#include "counter_rng.cuh"
#include "pendulum_mpf.cuh"
#include "phase_clock.cuh"

namespace {

using namespace dust_solve;
using dust_cartpole::CartPoleLik;
using dust_cartpole::Model;
using dust_rng::normal_at;
using dust_rng::rng_key;
using dust_rng::uniform_at;

struct EpisodeArgs {
  const float* scal;   // [14] shared scalars (ops/cartpole_episode.py)
  const float* ep_f;   // [B, 2] true length, true mass_pole
  const int* ep_i;     // [B, 3] seed0, seed1, scenario
  const float* theta0;
  const float* locs0;
  const float* amat0;  // [B, m, hz]
  const float* mpfx0;  // [B, m_mpf, 2]
  float* eps;          // [B, hz, m, n_act]: each step's action noise
  float* log;          // [B, steps, kLogFields]
  float* theta_out;
  float* locs_out;
  float* amat_out;     // [B, m, hz]
  float* mpfx_out;     // [B, m_mpf, 2]
  long long* clock;    // [B, kClockSlots] (the clocked build), or null
  unsigned long long* fallbacks;  // [1] the rollouts' fallbacks, or null
  int steps, hz, m, n_params, n_act, m_mpf, mpf_steps, load_step;
  Model model;
  float load_scale, log_n_act;
  int exp_util, log_space, fixed_bw;
  float mpf_fixed_bw, mpf_bw_scale;
};

// The phases of one step that the clocked build times, K5's
// (ops/cartpole_episode.py:CLOCK_PHASES, phase_clock.cuh).
enum : int {
  kClkNoise = 0, kClkSilverman, kClkDraws, kClkRollouts, kClkDisco,
  kClkDelta, kClkStein, kClkCommit, kClkMpfBw, kClkMpf, kClkLog,
  kClkPhases,
  kClockSlots = kClkPhases + 2
};

// lanes that share one entry's sum over the action samples in the DISCO
// delta (ops/cartpole_episode.py:SUM_LANES)
constexpr int kSumLanes = 8;
// draws whose rollout chains a thread advances together
constexpr int kChainDraws = 4;
constexpr int kLogFields = 8;
// sv: 0-3 the state, 4 prior_bw, 5 bw_sv, 6 action, 7-10 the next state,
// 11 cost; the last slot holds the Stein step's argmax
constexpr int kSv = 16;
// the floats before the MPF block (episode_smem_floats' constant terms): a
// multiple of 4, so that its float4 scratch is 16-byte aligned
static_assert((3 * kMaxM * kMaxM + 5 * kMaxM + 5 * kMaxParams + 2 * kWarps +
               8 + kSv) % 4 == 0,
              "the MPF scratch is 16-byte aligned");

__host__ __device__ inline size_t episode_smem_floats(int m, int hz,
                                                      int n_act, int m_mpf) {
  return 5 * static_cast<size_t>(m) * hz + 3 * static_cast<size_t>(m) * n_act +
         3 * kMaxM * kMaxM + 5 * kMaxM + 5 * kMaxParams + 2 * kWarps + 8 +
         10 * static_cast<size_t>(m_mpf) + kSv;
}

template <bool kClock>
__global__ void __launch_bounds__(kThreads, 2)
    cartpole_episode_kernel(EpisodeArgs a) {
  extern __shared__ __align__(16) float sh[];
  __shared__ long long clk_acc[kClkPhases];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int m = a.m, hz = a.hz, n_act = a.n_act, n_params = a.n_params;
  const int m_mpf = a.m_mpf;
  const int mh = m * hz;
  const int ma = m * n_act;
  const int n_eps = hz * ma;

  // the arrays of fixed size first, at constant offsets; then the MPF
  // block, its float4 scratch 16-byte aligned; then the policy arrays
  SteinSmem ss;
  ss.lp = sh;
  ss.r = ss.lp + kMaxM * kMaxM;
  ss.kmat = ss.r + kMaxM * kMaxM;
  ss.rowsum = ss.kmat + kMaxM * kMaxM;
  ss.log_w = ss.rowsum + kMaxM;
  ss.weights = ss.log_w + kMaxM;
  float* eta = ss.weights + kMaxM;
  float* log_l = eta + kMaxM;
  float* lens = log_l + kMaxM;         // the draws' lengths
  float* mps = lens + kMaxParams;      // and pole masses
  float* pdz = mps + kMaxParams;       // [n_params, 2]
  float* pdu = pdz + 2 * kMaxParams;   // [n_params]
  float* red = pdu + kMaxParams;       // 2 * kWarps + 8
  float* sv = red + 2 * kWarps + 8;    // simulator and step scalars [kSv]
  ss.i_star = reinterpret_cast<int*>(sv + kSv - 1);
  float* mpf_w = sv + kSv;             // MPF scratch [8 m_mpf]
  float* sx0 = mpf_w + 8 * m_mpf;      // MPF particles: lengths, then masses
  float* sx1 = sx0 + m_mpf;
  float* theta = sx1 + m_mpf;
  float* locs = theta + mh;
  float* amat = locs + mh;
  float* score = amat + mh;
  float* theta_new = score + mh;
  float* mcost = theta_new + mh;
  float* omega = mcost + ma;
  float* w_lik = omega + ma;

  // scal: [x0, x_dot0, ctrl_sigma, lr, alpha, inv_temp, inv_s2, inv_ps2,
  //        mpf_lr, mpf_sigma, prior_bw0, log_mix, th0, th_dot0]
  const float* sc = a.scal;
  const float sigma_c = sc[2], lr = sc[3], inv_s2 = sc[6], inv_ps2 = sc[7];
  const float mpf_lr = sc[8], mpf_sigma = sc[9];
  const float log_mix = sc[11];
  const DiscoConsts dk{sc[5], sc[4], a.log_n_act,
                       static_cast<float>(1.0 / n_act), a.exp_util};
  const Model& km = a.model;
  const float l_true = a.ep_f[2 * b], mp_true = a.ep_f[2 * b + 1];
  const uint32_t seed0 = static_cast<uint32_t>(a.ep_i[3 * b]);
  const uint32_t seed1 = static_cast<uint32_t>(a.ep_i[3 * b + 1]);
  const uint32_t scen = static_cast<uint32_t>(a.ep_i[3 * b + 2]);

  for (int e = tid; e < mh; e += nt) {
    theta[e] = a.theta0[b * mh + e];
    locs[e] = a.locs0[b * mh + e];
    amat[e] = a.amat0[b * mh + e];
  }
  for (int i = tid; i < m_mpf; i += nt) {
    sx0[i] = a.mpfx0[(b * m_mpf + i) * 2];
    sx1[i] = a.mpfx0[(b * m_mpf + i) * 2 + 1];
  }
  if (tid == 0) {
    sv[0] = sc[0];
    sv[1] = sc[1];
    sv[2] = sc[12];
    sv[3] = sc[13];
    sv[4] = sc[10];
  }
  __syncthreads();
  dust_clock::PhaseClock<kClock, kClkPhases> clk(clk_acc);

  for (int step = 0; step < a.steps; ++step) {
    // ---- noise: action eps [hz, m, n_act], draws pdz [P, 2], pdu [P] ----
    float* eps = a.eps + static_cast<size_t>(b) * n_eps;
    {
      const uint32_t key = rng_key(seed0, seed1, step, scen);
      for (int e = tid; e < n_eps; e += nt) eps[e] = normal_at(key, e);
      if (tid < 2 * n_params) pdz[tid] = normal_at(key, n_eps + tid);
      if (tid < n_params)
        pdu[tid] = uniform_at(key, 2u * (n_eps + 2 * n_params) + tid);
    }
    __syncthreads();
    clk.mark(kClkNoise);

    // ---- Silverman bandwidth of the policy particles ----
    const float bw_sv = silverman(theta, mh, red);
    clk.mark(kClkSilverman);

    // ---- (length, mass_pole) draws from the live MPF prior ----
    const float prior_bw = sv[4];
    if (tid < n_params) {
      const float u = pdu[tid];
      const float fi = fminf(floorf(u * static_cast<float>(m_mpf)),
                             static_cast<float>(m_mpf - 1));
      const int idx = max(0, min(static_cast<int>(fi), m_mpf - 1));
      float l = sx0[idx] + prior_bw * pdz[2 * tid];
      float mp = sx1[idx] + prior_bw * pdz[2 * tid + 1];
      if (a.log_space) {
        l = expf(l);
        mp = expf(mp);
      }
      lens[tid] = l;
      mps[tid] = mp;
    }
    __syncthreads();
    clk.mark(kClkDraws);

    // ---- rollouts + costs ----
    dust_cartpole::rollout_mcost<kChainDraws>(
        sv, lens, mps, n_params, m, hz, n_act, km,
        [&](int q, int i, int t) { return eps[(t * m + q) * n_act + i]; },
        [&](int q, int t, float e) { return theta[q * hz + t] + sigma_c * e; },
        mcost, a.fallbacks);
    __syncthreads();
    clk.mark(kClkRollouts);
    disco_weights(mcost, m, n_act, dk, omega, w_lik, eta, log_l, red);
    clk.mark(kClkDisco);

    // ---- DISCO delta and likelihood gradient: the weights sum to 1, so
    // sum_i w (theta + sigma eps) = theta + sigma sum_i w eps, and theta
    // cancels in the gradient; kSumLanes lanes per
    // entry, lane s taking the samples i = s, s + kSumLanes, ..., then a
    // butterfly in a fixed order ----
    {
      const int sub = tid % kSumLanes;
      const unsigned mask = lane_group_mask(kSumLanes);
      for (int e = tid / kSumLanes; e < mh; e += nt / kSumLanes) {
        const int q = e / hz;
        const int t = e - q * hz;
        const float* et = eps + (t * m + q) * n_act;
        float de = 0.0f, we = 0.0f;
        for (int i = sub; i < n_act; i += kSumLanes) {
          de = de + omega[q * n_act + i] * et[i];
          we = we + w_lik[q * n_act + i] * et[i];
        }
        de = lane_group_sum<kSumLanes>(de, mask);
        we = lane_group_sum<kSumLanes>(we, mask);
        if (sub == 0) {
          amat[e] = amat[e] + (theta[e] + sigma_c * de);
          score[e] = sigma_c * we * inv_s2;
        }
      }
    }
    __syncthreads();
    clk.mark(kClkDelta);

    // ---- Stein step + forward ----
    stein_forward(theta, locs, score, &log_mix, 0, log_l, m, hz, bw_sv, lr,
                  inv_ps2, ss, theta_new);
    clk.mark(kClkStein);

    // ---- commits: the plans and the prior's locations rolled forward ----
    const int star = *ss.i_star;
    for (int e = tid; e < mh; e += nt) {
      const int q = e / hz;
      const int t = e - q * hz;
      const float fwd = theta_new[q * hz + min(t + 1, hz - 1)];
      theta[e] = fwd;
      locs[e] = fwd;
    }
    if (tid == 0) {
      // ---- simulator: the cart-pole with the true parameters ----
      const float action = star < m ? theta_new[star * hz] : 0.0f;
      const float mp = step >= a.load_step ? mp_true * a.load_scale : mp_true;
      const float M = km.mc + mp;
      const float pm = mp * l_true;
      float s, c;
      sincosf(sv[2], &s, &c);
      float xdd, tdd;
      dust_cartpole::accel(km, sv[1], s, c, sv[3],
                           clampf(action, -1.0f, 1.0f) * km.f_mag, l_true, mp,
                           M, 1.0f / M, pm, 1.0f / pm, xdd, tdd);
      const float x2 = sv[0] + sv[1] * km.dt;
      const float xd2 = sv[1] + xdd * km.dt;
      const float th2 = sv[2] + sv[3] * km.dt;
      const float thd2 = sv[3] + tdd * km.dt;
      sv[5] = bw_sv;
      sv[6] = action;
      sv[7] = x2;
      sv[8] = xd2;
      sv[9] = th2;
      sv[10] = thd2;
      sv[11] = dust_cartpole::state_cost(x2, xd2, cosf(th2), thd2);
    }
    clk.mark(kClkCommit);
    // ---- MPF update: Silverman bandwidth of the flattened particles,
    // then the Stein loop centered on them with the previous bandwidth ----
    const float bw_mpf = a.fixed_bw
                             ? a.mpf_fixed_bw
                             : silverman(sx0, 2 * m_mpf, red) * a.mpf_bw_scale;
    __syncthreads();
    clk.mark(kClkMpfBw);
    {
      const CartPoleLik lik(km, sv, sv[6], sv + 7, mpf_sigma, a.log_space);
      dust_mpf::episode_stein_loop(
          sx0, sx1, mpf_w, m_mpf, a.mpf_steps,
          dust_mpf::stein_consts(m_mpf, bw_mpf, prior_bw, mpf_lr), lik);
    }
    clk.mark(kClkMpf);
    if (tid == 0) {
      float* row =
          a.log + (static_cast<size_t>(b) * a.steps + step) * kLogFields;
      for (int f = 0; f < 4; ++f) row[f] = sv[7 + f];
      row[4] = sv[6];
      row[5] = sv[11];
      row[6] = sv[5];
      row[7] = bw_mpf;
      for (int f = 0; f < 4; ++f) sv[f] = sv[7 + f];
      sv[4] = bw_mpf;
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
    a.mpfx_out[(b * m_mpf + i) * 2] = sx0[i];
    a.mpfx_out[(b * m_mpf + i) * 2 + 1] = sx1[i];
  }
}

template <bool kClock>
int launch(int B, const EpisodeArgs& a, cudaStream_t stream) {
  if (B < 1 || a.m < 1 || a.m > kMaxM || a.n_params < 1 ||
      a.n_params > kMaxParams || a.m_mpf < 1 || a.m_mpf > kThreads ||
      a.hz < 1 || a.n_act < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes =
      episode_smem_floats(a.m, a.hz, a.n_act, a.m_mpf) * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cartpole_episode_kernel<kClock>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cartpole_episode_kernel<kClock><<<B, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// B episodes, one block each. Arguments: see EpisodeArgs. Device pointers,
// float32 (ep_i int32), contiguous; eps is scratch the kernel writes each
// step's noise to. g, mass_cart, mu_c, mu_p, f_mag, dt: the model's
// constants; log_n_act = log(n_act), folded by the caller in double
// precision. clock, when not null, is [B, kClockSlots] int64: the launch
// then takes the build of the kernel that times the phases of a step (the
// other build has no clock code). fallbacks, when not null, is one int64
// that each thread's rollout chunk-step taking the library's sincosf and
// `/` adds 1 to (cartpole.cuh:rollout_mcost); a chunk-step is one step of
// a pair's kChainDraws chains, or their final cosine.
extern "C" int dust_cartpole_episodes(
    const float *scal, const float *ep_f, const int *ep_i,
    const float *theta0, const float *locs0, const float *amat0,
    const float *mpfx0, float *eps, float *log, float *theta_out,
    float *locs_out, float *amat_out, float *mpfx_out, long long *clock,
    unsigned long long *fallbacks, int B, int steps, int hz, int m, int n_params, int n_act, int m_mpf,
    int mpf_steps, int load_step, float dt, float g, float mass_cart,
    float mu_c, float mu_p, float f_mag, float load_scale, float log_n_act,
    int exp_util, int log_space, int fixed_bw, float mpf_fixed_bw,
    float mpf_bw_scale, void *stream) {
  EpisodeArgs a{scal, ep_f, ep_i, theta0, locs0, amat0, mpfx0, eps, log,
                theta_out, locs_out, amat_out, mpfx_out, clock, fallbacks,
                steps, hz, m, n_params, n_act, m_mpf, mpf_steps, load_step,
                Model{g, mass_cart, mu_c, mu_p, f_mag, dt}, load_scale,
                log_n_act, exp_util, log_space, fixed_bw, mpf_fixed_bw,
                mpf_bw_scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return clock != nullptr ? launch<true>(B, a, s) : launch<false>(B, a, s);
}
