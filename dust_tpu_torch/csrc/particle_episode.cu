// Whole particle-navigation DuSt episodes in one launch (K9): one block
// per episode.
//
// Replaces the TPU kernel `fused_particle_episode`
// (dust_tpu/ops/pallas_particle_episode.py, `_particle_episode_kernel`).
//
// Each of `steps` iterations: action noise and mass draws (read from
// host-noise inputs, or drawn by the counter-based generator,
// counter_rng.cuh) -> Silverman bandwidth of the policy particles -> mass
// draws from the live MPF prior -> the SVMPC solve (K8's body:
// particle.cuh rollouts, stein.cuh softmaxes and Stein step) -> warm-up
// gate of the action, the particles and the weighted-prior refresh ->
// simulator step with the true mass (+load from change_at), crash freeze,
// the state frozen once done -> the MPF mass-posterior update (K7's body,
// particle_mpf.cuh), gated on step >= warm_up and not done, with the crash
// factor at the likelihood's previous observation -> cost, crash and
// success detection against the pre-step done -> one log row.
//
// Bound on this card: a 200-step demo episode reads and writes ~16 KB and
// does ~2.2 G float32 and integer operations (chip_smoke.py:_k9_bound):
// ~33 us of the card's float32 rate. A single episode is bound by the
// latency of its serial chain: per step, a 40-step rollout chain, a dozen
// block-wide reductions, the Silverman sorts and the 20 dependent MPF
// iterations.
// Design: one persistent block of 256 threads per episode keeps every
// piece of state (model and map, particles, plans, prior log-weights, MPF
// particles, simulator state) in shared memory for the whole episode;
// nothing returns to the host. The 1,536 trajectories of a step (4 mass
// draws x 6 particles x 64 samples) take one thread each in turn, six full
// rounds of 256 (measured faster than 4 or 2 draws per thread as
// independent chains), and each pair's draws are summed afterwards in draw
// order (stein.cuh:sum_draws); the per-step noise (120 KB at the
// demo shapes) lives in device memory, read one step ahead of the chain.
// The DISCO delta takes 8 lanes per entry (neighbouring noise values), the
// MPF loop a quad of lanes per particle (particle_mpf.cuh), and the
// Silverman bandwidths their order statistics from a bitonic sort in
// shared memory (stein.cuh:silverman_sorted) in place of the O(n^2) rank
// count. A grid of B blocks runs B independent episodes, two blocks per SM
// (<= 128 registers).
// The clocked build (kClock) stamps the phases of each step (chip_smoke.py
// reads it through ops/particle_episode.py:phase_clock).

#include <cuda_runtime.h>
#include <stdint.h>

#include "counter_rng.cuh"
#include "particle.cuh"
#include "particle_mpf.cuh"
#include "phase_clock.cuh"
#include "stein.cuh"

namespace {

using namespace dust_solve;
using dust_particle::kModelFloats;
namespace dp = dust_particle;

struct EpisodeArgs {
  const float* model;      // ops/particle_rollout.py:model_tensor
  const float* scal;       // [15] ops/particle_episode.py:episode_scal
  const float* base_mass;  // [B]
  const int* ep_i;         // [B, 3] seed0, seed1, scenario
  const float* logmix0;    // [m]
  const float* theta0;
  const float* locs0;
  const float* amat0;      // [B, m, hz * 2]
  const float* aseq;       // [hz * 2]
  const float* mpfx0;      // [B, m_mpf]
  float* eps;  // host: [B, steps, 2, hz, m, n_act]; else [B, 2 hz m n_act]
  const float* pdz;        // [B, steps, n_params] (host-noise mode)
  const float* pdu;        // [B, steps, n_params]
  float* log;              // [B, steps, 12]
  float* theta_out;
  float* locs_out;
  float* amat_out;         // [B, m, hz * 2]
  float* mpfx_out;         // [B, m_mpf]
  float* logmix_out;       // [B, m] final prior log-weights, or null
  long long* clock;        // [B, kClockSlots] (the clocked build), or null
  int steps, warm_up, hz, m, n_params, n_act, m_mpf, mpf_steps, change_at;
  float success_dist2, log_n_act;
  int exp_util, weighted_prior, log_space, fixed_bw;
  float mpf_bw_scale;
  int host_noise;
};

constexpr int kLogFields = 12;
// lanes that share one entry's sum over the action samples in the DISCO
// delta (ops/particle_episode.py:SUM_LANES)
constexpr int kSumLanes = 8;
// The phases of one step that the clocked build of the kernel times
// (ops/particle_episode.py:CLOCK_PHASES, phase_clock.cuh).
enum : int {
  kClkNoise = 0, kClkSilverman, kClkDraws, kClkRollouts, kClkDisco,
  kClkDelta, kClkStein, kClkCommit, kClkMpfBw, kClkMpf, kClkTail,
  kClkPhases,
  kClockSlots = kClkPhases + 2
};

// simulator and step scalars in shared memory
enum : int {
  kPx = 0, kPy, kVx, kVy,           // simulator state
  kDone, kCrashed, kCum,
  kLikPx, kLikPy, kLikVx, kLikVy,   // the MPF likelihood's observation
  kPriorBw,
  kAx, kAy,                         // the action taken
  kNpx, kNpy, kNvx, kNvy,           // the new state
  kScalars = 24                     // the last slot holds i_star
};

// the smallest power of two >= n: the Silverman sort's length
__host__ __device__ inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

__host__ __device__ inline size_t episode_smem_floats(int m, int ev,
                                                      int n_act, int m_mpf,
                                                      int n_params) {
  return kModelFloats + 5 * static_cast<size_t>(m) * ev +
         3 * static_cast<size_t>(m) * n_act + 3 * kMaxM * kMaxM +
         6 * kMaxM + 3 * kMaxParams + 2 * kWarps + 8 +
         4 * static_cast<size_t>(m_mpf) + kScalars +
         static_cast<size_t>(n_params) * m * n_act +
         pow2_at_least(m * ev > m_mpf ? m * ev : m_mpf);
}

template <bool kClock>
__global__ void __launch_bounds__(kThreads, 2)
    particle_episode_kernel(EpisodeArgs a) {
  extern __shared__ float sh[];
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

  float* km = sh;
  float* theta = km + kModelFloats;
  float* locs = theta + mh;
  float* amat = locs + mh;
  float* score = amat + mh;
  float* theta_new = score + mh;
  float* mcost = theta_new + mh;
  float* omega = mcost + ma;
  float* w_lik = omega + ma;
  SteinSmem ss;
  ss.lp = w_lik + ma;
  ss.r = ss.lp + kMaxM * kMaxM;
  ss.kmat = ss.r + kMaxM * kMaxM;
  ss.rowsum = ss.kmat + kMaxM * kMaxM;
  ss.log_w = ss.rowsum + kMaxM;
  ss.weights = ss.log_w + kMaxM;
  float* eta = ss.weights + kMaxM;
  float* log_l = eta + kMaxM;
  float* logmix = log_l + kMaxM;      // prior mixture log-weights
  float* im = logmix + kMaxM;         // 1/mass per draw
  float* pdz = im + kMaxParams;
  float* pdu = pdz + kMaxParams;
  float* red = pdu + kMaxParams;      // 2 * kWarps + 8
  float* sx = red + 2 * kWarps + 8;   // MPF (log-)mass particles
  float* scc = sx + m_mpf;            // MPF prior centers
  float* st = scc + m_mpf;            // MPF drive terms
  float* sn = st + m_mpf;             // MPF new particles
  float* sv = sn + m_mpf;             // [kScalars]
  ss.i_star = reinterpret_cast<int*>(sv + kScalars - 1);
  float* dcost = sv + kScalars;       // [n_params, m * n_act] draw costs
  float* srt = dcost + n_params * ma; // the Silverman sort
  const int n_sort = pow2_at_least(mh);
  const int n_sort_mpf = pow2_at_least(m_mpf);
  const SilvermanN sv_n = silverman_n(mh);
  const SilvermanN mpf_n = silverman_n(m_mpf);

  // scal: [px0, py0, vx0, vy0, ctrl_sigma, lr, alpha, inv_temp, inv_s2,
  //        inv_ps2, load, mpf_lr, mpf_sigma, prior_bw0, mpf_fixed_bw]
  const float* sc = a.scal;
  const float sigma_c = sc[4], lr = sc[5], inv_s2 = sc[8], inv_ps2 = sc[9];
  const float load = sc[10], mpf_lr = sc[11], mpf_sigma = sc[12];
  const DiscoConsts dk{sc[7], sc[6], a.log_n_act,
                       static_cast<float>(1.0 / n_act), a.exp_util};
  const float base_mass = a.base_mass[b];
  const uint32_t seed0 = static_cast<uint32_t>(a.ep_i[3 * b]);
  const uint32_t seed1 = static_cast<uint32_t>(a.ep_i[3 * b + 1]);
  const uint32_t scen = static_cast<uint32_t>(a.ep_i[3 * b + 2]);

  for (int e = tid; e < mh; e += nt) {
    theta[e] = a.theta0[b * mh + e];
    locs[e] = a.locs0[b * mh + e];
    amat[e] = a.amat0[b * mh + e];
  }
  for (int i = tid; i < m_mpf; i += nt) sx[i] = a.mpfx0[b * m_mpf + i];
  if (tid < m) logmix[tid] = a.logmix0[tid];
  if (tid == 0) {
    for (int k = 0; k < 4; ++k) {
      sv[kPx + k] = sc[k];
      sv[kLikPx + k] = sc[k];
    }
    sv[kDone] = 0.0f;
    sv[kCrashed] = 0.0f;
    sv[kCum] = 0.0f;
    sv[kPriorBw] = sc[13];
  }
  dp::load_model(a.model, km);  // synchronises the block
  const float dt = km[dp::kDt], max_acc = km[dp::kMaxAcc];
  const float max_speed = km[dp::kMaxSpeed];
  const bool crash = km[dp::kCrash] != 0.0f;

  dust_clock::PhaseClock<kClock, kClkPhases> clk(clk_acc);

  for (int step = 0; step < a.steps; ++step) {
    // ---- noise: eps [2, hz, m, n_act], mass draws pdz, pdu [n_params] ----
    const float* eps;
    if (a.host_noise) {
      const size_t d = static_cast<size_t>(b) * a.steps + step;
      eps = a.eps + d * n_eps;
      if (tid < n_params) {
        pdz[tid] = a.pdz[d * n_params + tid];
        pdu[tid] = a.pdu[d * n_params + tid];
      }
    } else {
      float* ew = a.eps + static_cast<size_t>(b) * n_eps;
      const uint32_t key = dust_rng::rng_key(seed0, seed1, step, scen);
      for (int e = tid; e < n_eps; e += nt) ew[e] = dust_rng::normal_at(key, e);
      if (tid < n_params) {
        pdz[tid] = dust_rng::normal_at(key, n_eps + tid);
        pdu[tid] = dust_rng::uniform_at(key, 2u * (n_eps + n_params) + tid);
      }
      eps = ew;
    }
    __syncthreads();
    clk.mark(kClkNoise);
    const bool active = step >= a.warm_up;
    // the MPF gate: step >= warm_up and not done before this step
    const bool gate = active && sv[kDone] <= 0.5f;

    // ---- Silverman bandwidth of the policy particles ----
    const float bw_sv = silverman_sorted(theta, sv_n, n_sort, srt, red);
    clk.mark(kClkSilverman);

    // ---- mass draws from the live MPF prior ----
    const float prior_bw = sv[kPriorBw];
    if (tid < n_params) {
      const float fi = fminf(floorf(pdu[tid] * static_cast<float>(m_mpf)),
                             static_cast<float>(m_mpf - 1));
      const int idx = max(0, min(static_cast<int>(fi), m_mpf - 1));
      float d = sx[idx] + prior_bw * pdz[tid];
      if (a.log_space) d = expf(d);
      im[tid] = 1.0f / d;
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
      dcost[u] = dp::trajectory_cost(
          km, sv[kPx], sv[kPy], sv[kVx], sv[kVy], im[p], hz,
          [&](int t) {
            return make_float2(ep[t * ma], ep[(hz + t) * ma]);
          },
          [&](int t, float2 e, float& ax, float& ay) {
            ax = th[2 * t] + sigma_c * e.x;
            ay = th[2 * t + 1] + sigma_c * e.y;
          });
    }
    __syncthreads();
    sum_draws(dcost, n_params, ma, mcost);
    __syncthreads();
    clk.mark(kClkRollouts);
    disco_weights(mcost, m, n_act, dk, omega, w_lik, eta, log_l, red);
    clk.mark(kClkDisco);

    // ---- DISCO delta and likelihood gradient: kSumLanes lanes per
    // entry, lane s taking the samples i = s, s + kSumLanes, ... (reads of
    // neighbouring noise values), then a butterfly in a fixed order ----
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
          d = d + omega[q * n_act + i] * (av - a.aseq[l]);
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
      const float a_x = af * (star < m ? theta_new[star * ev] : 0.0f);
      const float a_y = af * (star < m ? theta_new[star * ev + 1] : 0.0f);
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
      // ---- simulator: the model with the true mass, crash freeze,
      // frozen once done ----
      const float spx = sv[kPx], spy = sv[kPy], svx = sv[kVx], svy = sv[kVy];
      const float sim_mass =
          step >= a.change_at ? base_mass + load : base_mass;
      const float s_scale =
          crash ? dt * (1.0f - dp::occupancy(km, spx, spy)) : dt;
      const float acc_x = clampf(a_x / sim_mass, -max_acc, max_acc);
      const float acc_y = clampf(a_y / sim_mass, -max_acc, max_acc);
      const bool frozen = sv[kDone] > 0.5f;
      sv[kNpx] = frozen ? spx : spx + svx * s_scale;
      sv[kNpy] = frozen ? spy : spy + svy * s_scale;
      sv[kNvx] = frozen ? svx
                        : clampf(svx + acc_x * s_scale, -max_speed, max_speed);
      sv[kNvy] = frozen ? svy
                        : clampf(svy + acc_y * s_scale, -max_speed, max_speed);
      sv[kAx] = a_x;
      sv[kAy] = a_y;
    }
    clk.mark(kClkCommit);
    // ---- MPF update, gated on step >= warm_up and not done; its prior
    // bandwidth is the previous update's ----
    const float bw_mpf = a.fixed_bw ? sc[14]
                                    : silverman_sorted(sx, mpf_n, n_sort_mpf,
                                                       srt, red) *
                                          a.mpf_bw_scale;
    __syncthreads();
    clk.mark(kClkMpfBw);
    if (gate) {
      for (int i = tid; i < m_mpf; i += nt) scc[i] = sx[i];
      __syncthreads();
      const float mscale =
          crash ? dt * (1.0f - dp::occupancy(km, sv[kLikPx], sv[kLikPy]))
                : dt;
      const dp::MassMpf k{bw_mpf, prior_bw, mpf_lr, mpf_sigma,
                          sv[kLikVx], sv[kLikVy], sv[kAx], sv[kAy],
                          sv[kNvx], sv[kNvy], mscale};
      dp::mass_stein_loop(sx, scc, st, sn, m_mpf, a.mpf_steps, k, max_acc,
                          max_speed, a.log_space);
    }
    clk.mark(kClkMpf);
    if (tid == 0) {
      if (gate) {
        sv[kPriorBw] = bw_mpf;
        for (int k = 0; k < 4; ++k) sv[kLikPx + k] = sv[kNpx + k];
      }
      // ---- cost, then crash / goal detection against the pre-step done
      const float npx = sv[kNpx], npy = sv[kNpy], nvx = sv[kNvx];
      const float nvy = sv[kNvy];
      const float done0 = sv[kDone];
      const float occ_n = dp::occupancy(km, npx, npy);
      const float dx = npx - km[dp::kTx], dy = npy - km[dp::kTy];
      const float dvx = nvx - km[dp::kTvx], dvy = nvy - km[dp::kTvy];
      float cost = km[dp::kWpx] * (dx * dx);
      cost = cost + km[dp::kWpy] * (dy * dy);
      cost = cost + km[dp::kWvx] * (dvx * dvx);
      cost = cost + km[dp::kWvy] * (dvy * dvy);
      cost = cost + km[dp::kWobs] * occ_n;
      const float cum = sv[kCum] + (1.0f - done0) * cost;
      const bool crash_now = occ_n > 0.0f;
      float dist2 = dx * dx;
      dist2 = dist2 + dy * dy;
      dist2 = dist2 + dvx * dvx;
      dist2 = dist2 + dvy * dvy;
      const bool success_now = dist2 <= a.success_dist2;
      const float crashed =
          maxp(sv[kCrashed], (crash_now && done0 < 0.5f) ? 1.0f : 0.0f);
      const float done = maxp(done0, (crash_now || success_now) ? 1.0f : 0.0f);
      float* row = a.log + (static_cast<size_t>(b) * a.steps + step) *
                               kLogFields;
      row[0] = npx;
      row[1] = npy;
      row[2] = nvx;
      row[3] = nvy;
      row[4] = sv[kAx];
      row[5] = sv[kAy];
      row[6] = cost;
      row[7] = done;
      row[8] = crashed;
      row[9] = cum;
      row[10] = bw_sv;
      row[11] = bw_mpf;
      sv[kPx] = npx;
      sv[kPy] = npy;
      sv[kVx] = nvx;
      sv[kVy] = nvy;
      sv[kDone] = done;
      sv[kCrashed] = crashed;
      sv[kCum] = cum;
    }
    __syncthreads();
    clk.mark(kClkTail);
  }
  clk.write(a.clock + static_cast<size_t>(b) * kClockSlots);

  for (int e = tid; e < mh; e += nt) {
    a.theta_out[b * mh + e] = theta[e];
    a.locs_out[b * mh + e] = locs[e];
    a.amat_out[b * mh + e] = amat[e];
  }
  for (int i = tid; i < m_mpf; i += nt) a.mpfx_out[b * m_mpf + i] = sx[i];
  if (a.logmix_out != nullptr && tid < m)
    a.logmix_out[b * m + tid] = logmix[tid];
}

template <bool kClock>
int launch_episodes(const EpisodeArgs& a, int B, cudaStream_t stream) {
  if (B < 1 || a.m < 1 || a.m > kMaxM || a.n_params < 1 ||
      a.n_params > kMaxParams || a.m_mpf < 1 || a.m_mpf > kThreads ||
      a.hz < 1 || a.n_act < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes =
      episode_smem_floats(a.m, 2 * a.hz, a.n_act, a.m_mpf, a.n_params) *
      sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        particle_episode_kernel<kClock>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  particle_episode_kernel<kClock><<<B, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// B episodes, one block each (K9 launches B = 1; K10, the particle
// scenario sweep, one block per (group, chain, scenario)). Arguments: see
// EpisodeArgs. Device pointers, float32 (ep_i int32), contiguous; pdz and
// pdu may be null (device-RNG mode), logmix_out null where the caller does
// not read the final prior log-weights (K9). success_dist2 =
// success_dist^2 and log_n_act = log(n_act), folded by the caller.
// clock, when not null, is [B, kClockSlots] int64: the launch then takes
// the build of the kernel that times the phases of a step (the other build
// has no clock code).
extern "C" int dust_particle_episodes(
    const float* model, const float* scal, const float* base_mass,
    const int* ep_i, const float* logmix0, const float* theta0,
    const float* locs0, const float* amat0, const float* aseq,
    const float* mpfx0, float* eps, const float* pdz, const float* pdu,
    float* log, float* theta_out, float* locs_out, float* amat_out,
    float* mpfx_out, float* logmix_out, long long* clock, int B, int steps,
    int warm_up, int hz, int m, int n_params, int n_act, int m_mpf,
    int mpf_steps, int change_at, float success_dist2, float log_n_act,
    int exp_util, int weighted_prior, int log_space, int fixed_bw,
    float mpf_bw_scale, int host_noise, void* stream) {
  const EpisodeArgs a{model, scal, base_mass, ep_i, logmix0, theta0, locs0,
                      amat0, aseq, mpfx0, eps, pdz, pdu, log, theta_out,
                      locs_out, amat_out, mpfx_out, logmix_out, clock, steps,
                      warm_up, hz, m, n_params, n_act, m_mpf, mpf_steps,
                      change_at, success_dist2, log_n_act, exp_util,
                      weighted_prior, log_space, fixed_bw, mpf_bw_scale,
                      host_noise};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return clock != nullptr ? launch_episodes<true>(a, B, s)
                          : launch_episodes<false>(a, B, s);
}
