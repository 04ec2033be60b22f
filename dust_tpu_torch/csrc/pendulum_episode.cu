// Whole pendulum DuSt episodes in one launch: the single-episode kernel
// (K4) and the scenario sweep (K5) launch the same entry,
// dust_pendulum_episodes, and run the same block code.
//
// Replaces the TPU kernels `fused_pendulum_episode`
// (dust_tpu/ops/pallas_episode.py, `_pendulum_episode_kernel`) and
// `fused_pendulum_sweep_episode` (dust_tpu/ops/pallas_sweep_episode.py,
// `_pendulum_sweep_kernel`).
//
// Each of `steps` iterations: action noise and parameter draws (read
// from host-noise inputs, or drawn by the counter-based generator) ->
// Silverman bandwidth of the policy particles -> dynamics-parameter draws
// from the live MPF prior -> the SVMPC solve (pendulum_solve.cuh) with the
// delta and likelihood gradient in the theta + sigma * sum(w eps) form ->
// warm-up gate and state commit -> simulator step with the episode's true
// parameters -> Silverman bandwidth of the MPF particles and the MPF
// Stein loop (pendulum_mpf.cuh, K2's code) -> one log row.
//
// Bound on this card: a 200-step demo episode reads and writes ~8 KB and
// does ~1.1 G float32 and integer operations (~5.3 M per step,
// chip_smoke.py:_episodes_bound): ~16 us of the card's float32 rate, ~4 ms
// for the 256-episode sweep. A single episode is bound by the latency of
// its serial chain: per step, a 30-step rollout chain, a dozen block-wide
// reductions and the 20 dependent MPF iterations.
// Design, from the step's measured phases (the clocked build, kClock):
// one persistent block of 256 threads per episode keeps every piece of
// state (particles, plans, MPF particles, simulator state) in shared memory
// for the whole episode; nothing returns to the host. A sweep (K5) is a
// grid of such blocks, two per SM (<= 128 registers), so each scenario
// computes what an independent single-episode launch computes, bit for
// bit, and a diverged scenario cannot reach another one. A single episode
// (K4, B = 1) runs as a thread-block cluster of kK4Cluster blocks: each
// block draws the noise of its share of the (particle, sample) pairs and
// rolls them out, the pair costs meet over distributed shared memory, and
// every other phase runs in every block alike, so K4 computes K5's bits
// over four SMs. The rollouts hold a pair's eight draws in registers with
// a branch-free step (pendulum_solve.cuh); the DISCO delta takes 8 lanes
// per entry; the MPF loop a quad of lanes per particle, at the demos'
// 49-52 particles with each quad's row and each lane's squared distances
// in registers, its 13 columns unrolled branch-free
// (pendulum_mpf.cuh:episode_stein_loop, K2's register loop), the
// shared-memory walk at other sizes. The per-step noise
// lives in device memory (46 KB at the demo shapes; up to 512 KB at the
// shape ceiling), read through L1/L2.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "counter_rng.cuh"
#include "pendulum_mpf.cuh"
#include "pendulum_solve.cuh"
#include "phase_clock.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace dust_solve;
using dust_rng::normal_at;
using dust_rng::rng_key;
using dust_rng::uniform_at;

struct EpisodeArgs {
  const float* scal;   // [12] shared scalars (ops/episode.py:episode_scal)
  const float* ep_f;   // [B, 2] 1/true length, 1/true mass
  const int* ep_i;     // [B, 3] seed0, seed1, scenario
  const float* theta0;
  const float* locs0;
  const float* amat0;  // [B, m, hz]
  const float* aseq;   // [hz], or null: no a_seq term
  const float* mpfx0;  // [B, m_mpf, 2]
  float* eps;          // host: [B, steps, hz, m, n_act]; else [B, hz, m, n_act]
  const float* pdz;    // [B, steps, n_params, 2] (host-noise mode)
  const float* pdu;    // [B, steps, n_params]
  float* log;          // [B, steps, 6]
  float* theta_out;
  float* locs_out;
  float* amat_out;     // [B, m, hz]
  float* mpfx_out;     // [B, m_mpf, 2]
  long long* clock;    // [B, kClockSlots] (the clocked build), or null
  int steps, warm_up, hz, m, n_params, n_act, m_mpf, mpf_steps;
  RolloutConsts rk;    // model rollout: dt, xmax, cg, ca
  float half3g;        // 3 g_model 0.5 (MPF likelihood)
  float gs;            // -3 g_sim 0.5 (simulator)
  float log_n_act;
  int exp_util, log_space, fixed_bw;
  float mpf_fixed_bw, mpf_bw_scale;
  int host_noise;
};

// The phases of one step that the clocked build of the kernel times
// (ops/episode.py:CLOCK_PHASES, phase_clock.cuh).
enum : int {
  kClkNoise = 0, kClkSilverman, kClkDraws, kClkRollouts, kClkDisco,
  kClkDelta, kClkStein, kClkCommit, kClkMpfBw, kClkMpf, kClkLog,
  kClkPhases,
  kClockSlots = kClkPhases + 2
};

// lanes that share one entry's sum over the action samples in the DISCO
// delta (ops/episode.py:SUM_LANES)
constexpr int kSumLanes = 8;
// the blocks of the cluster that runs a single episode (B = 1, K4): a
// quarter of the demo's 384 pairs each; two were slower, eight no faster
constexpr int kK4Cluster = 4;

// the floats before the MPF block (episode_smem_floats' constant terms): a
// multiple of 4, so that its float4 scratch is 16-byte aligned
static_assert((3 * kMaxM * kMaxM + 5 * kMaxM + 5 * kMaxParams + 2 * kWarps +
               8 + 16) % 4 == 0,
              "the MPF scratch is 16-byte aligned");

__host__ __device__ inline size_t episode_smem_floats(int m, int hz,
                                                      int n_act, int m_mpf) {
  return 5 * static_cast<size_t>(m) * hz + 3 * static_cast<size_t>(m) * n_act +
         3 * kMaxM * kMaxM + 5 * kMaxM + 5 * kMaxParams + 2 * kWarps + 8 +
         10 * static_cast<size_t>(m_mpf) + 16;
}

template <bool kClock, bool kCluster>
__global__ void __launch_bounds__(kThreads, 2)
    pendulum_episode_kernel(EpisodeArgs a) {
  extern __shared__ __align__(16) float sh[];
  __shared__ long long clk_acc[kClkPhases];
  // kCluster: the blocks of one cluster share episode 0; block `rank` draws
  // the noise of its share of the (particle, sample) pairs and rolls them
  // out, every other phase runs in every block alike (the same bits), and
  // block 0 writes the results. Otherwise block b runs episode b alone.
  int rank = 0, n_rank = 1;
  if constexpr (kCluster) {
    rank = static_cast<int>(cg::this_cluster().block_rank());
    n_rank = static_cast<int>(cg::this_cluster().num_blocks());
  }
  const int b = kCluster ? 0 : blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int m = a.m, hz = a.hz, n_act = a.n_act, n_params = a.n_params;
  const int m_mpf = a.m_mpf;
  const int mh = m * hz;
  const int ma = m * n_act;
  const int n_eps = hz * ma;
  // this block's pairs [p_begin, p_end)
  const int share = (ma + n_rank - 1) / n_rank;
  const int p_begin = min(ma, rank * share);
  const int p_end = min(ma, p_begin + share);

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
  float* il = log_l + kMaxM;
  float* im = il + kMaxParams;
  float* pdz = im + kMaxParams;       // [n_params, 2]
  float* pdu = pdz + 2 * kMaxParams;  // [n_params]
  float* red = pdu + kMaxParams;      // 2 * kWarps + 8
  float* sv = red + 2 * kWarps + 8;   // simulator and step scalars [16]
  ss.i_star = reinterpret_cast<int*>(sv + 15);
  float* mpf_w = sv + 16;             // MPF scratch [8 m_mpf]
  float* sx0 = mpf_w + 8 * m_mpf;     // MPF particles: lengths, then masses
  float* sx1 = sx0 + m_mpf;
  float* theta = sx1 + m_mpf;
  float* locs = theta + mh;
  float* amat = locs + mh;
  float* score = amat + mh;
  float* theta_new = score + mh;
  float* mcost = theta_new + mh;
  float* omega = mcost + ma;
  float* w_lik = omega + ma;

  // scal: [th0, om0, ctrl_sigma, lr, alpha, inv_temp, inv_s2, inv_ps2,
  //        mpf_lr, mpf_sigma, prior_bw0, log_mix]
  const float* sc = a.scal;
  const float sigma_c = sc[2], lr = sc[3], inv_s2 = sc[6], inv_ps2 = sc[7];
  const float mpf_lr = sc[8], mpf_sigma = sc[9];
  const float log_mix = sc[11];
  const DiscoConsts dk{sc[5], sc[4], a.log_n_act,
                       static_cast<float>(1.0 / n_act), a.exp_util};
  const float il_true = a.ep_f[2 * b], im_true = a.ep_f[2 * b + 1];
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
  // sv: 0 th_s, 1 om_s, 2 prior_bw, 3 bw_sv, 4 action, 5 a_cl, 6 th2,
  //     7 om2, 8 bw_mpf, 9 cost
  if (tid == 0) {
    sv[0] = sc[0];
    sv[1] = sc[1];
    sv[2] = sc[10];
  }
  __syncthreads();
  dust_clock::PhaseClock<kClock, kClkPhases> clk(clk_acc);

  for (int step = 0; step < a.steps; ++step) {
    // every block has read the previous step's noise and pair costs
    if constexpr (kCluster) cg::this_cluster().sync();
    // ---- noise: action eps [hz, m, n_act], draws pdz [P, 2], pdu [P] ----
    float* eps;
    if (a.host_noise) {
      eps = a.eps + (static_cast<size_t>(b) * a.steps + step) * n_eps;
      const size_t d = static_cast<size_t>(b) * a.steps + step;
      if (tid < 2 * n_params) pdz[tid] = a.pdz[d * 2 * n_params + tid];
      if (tid < n_params) pdu[tid] = a.pdu[d * n_params + tid];
    } else {
      eps = a.eps + static_cast<size_t>(b) * n_eps;
      const uint32_t key = rng_key(seed0, seed1, step, scen);
      if constexpr (kCluster) {
        // the draws of this block's pairs, eps[t * m * n_act + pair]
        const int n_own = p_end - p_begin;
        for (int u = tid; u < n_own * hz; u += nt) {
          const int t = u / n_own;
          const int e = t * ma + p_begin + (u - t * n_own);
          eps[e] = normal_at(key, e);
        }
      } else {
        for (int e = tid; e < n_eps; e += nt) eps[e] = normal_at(key, e);
      }
      if (tid < 2 * n_params) pdz[tid] = normal_at(key, n_eps + tid);
      if (tid < n_params)
        pdu[tid] = uniform_at(key, 2u * (n_eps + 2 * n_params) + tid);
    }
    __syncthreads();
    clk.mark(kClkNoise);

    // ---- Silverman bandwidth of the policy particles ----
    const float bw_sv = silverman(theta, mh, red);
    clk.mark(kClkSilverman);

    // ---- dynamics-parameter draws from the live MPF prior ----
    const float th_s = sv[0], om_s = sv[1], prior_bw = sv[2];
    if (tid < n_params) {
      const float u = pdu[tid];
      const float fi = fminf(floorf(u * static_cast<float>(m_mpf)),
                             static_cast<float>(m_mpf - 1));
      const int idx = max(0, min(static_cast<int>(fi), m_mpf - 1));
      float l = sx0[idx] + prior_bw * pdz[2 * tid];
      float ms = sx1[idx] + prior_bw * pdz[2 * tid + 1];
      if (a.log_space) {
        l = expf(l);
        ms = expf(ms);
      }
      il[tid] = 1.0f / l;
      im[tid] = 1.0f / ms;
    }
    __syncthreads();
    clk.mark(kClkDraws);

    // ---- rollouts + costs ----
    rollout_mcost(
        th_s, om_s, il, im, n_params, p_begin, p_end, hz, n_act, a.rk,
        [&](int q, int i, int t) { return eps[(t * m + q) * n_act + i]; },
        [&](int q, int t, float e) { return theta[q * hz + t] + sigma_c * e; },
        mcost);
    if constexpr (kCluster) {
      // the other blocks' pair costs, over distributed shared memory; their
      // noise, in device memory, is visible after the cluster barrier too
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();
      for (int pair = tid; pair < ma; pair += nt) {
        const int r = pair / share;
        if (r != rank) mcost[pair] = cluster.map_shared_rank(mcost, r)[pair];
      }
    }
    __syncthreads();
    clk.mark(kClkRollouts);
    disco_weights(mcost, m, n_act, dk, omega, w_lik, eta, log_l, red);
    clk.mark(kClkDisco);

    // ---- DISCO delta and likelihood gradient: the weights sum to 1, so
    // sum_i w (theta + sigma eps - a_seq) = theta + sigma sum_i w eps -
    // a_seq, and theta cancels in the gradient; kSumLanes lanes per
    // entry, lane s taking the samples i = s, s + kSumLanes, ...
    // (neighbouring noise values), then a butterfly in a fixed order ----
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
          float delta = theta[e] + sigma_c * de;
          if (a.aseq != nullptr) delta = delta - a.aseq[t];
          amat[e] = amat[e] + delta;
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

    // ---- warm-up gate + commits ----
    const bool active = step >= a.warm_up;
    const int star = *ss.i_star;
    for (int e = tid; e < mh; e += nt) {
      const int q = e / hz;
      const int t = e - q * hz;
      const float fwd = theta_new[q * hz + min(t + 1, hz - 1)];
      theta[e] = active ? fwd : theta_new[e];
      if (active) locs[e] = fwd;
    }
    if (tid == 0) {
      // ---- simulator: gym Pendulum-v0 with the true parameters ----
      const float action = active && star < m ? theta_new[star * hz] : 0.0f;
      const float a_cl = clampf(action, -kMaxTorque, kMaxTorque);
      float om2 = om_s + (a.gs * il_true * sinf(th_s + dust_mpf::kPi) +
                          3.0f * im_true * il_true * il_true * a_cl) *
                             a.rk.dt;
      om2 = clampf(om2, -kMaxSpeed, kMaxSpeed);
      const float th2 = th_s + om2 * a.rk.dt;
      const float d = cosf(th2) - 1.0f;
      sv[3] = bw_sv;
      sv[4] = action;
      sv[5] = a_cl;
      sv[6] = th2;
      sv[7] = om2;
      sv[9] = kSwingW * (d * d) + om2 * om2;
    }
    clk.mark(kClkCommit);
    // ---- MPF update: Silverman bandwidth of the flattened particles,
    // then the Stein loop centered on them with the previous bandwidth ----
    const float bw_mpf = a.fixed_bw
                             ? a.mpf_fixed_bw
                             : silverman(sx0, 2 * m_mpf, red) * a.mpf_bw_scale;
    __syncthreads();
    clk.mark(kClkMpfBw);
    const float a_cl = sv[5], th2 = sv[6], om2 = sv[7];
    const dust_mpf::MpfConsts mk = dust_mpf::mpf_consts(
        m_mpf, bw_mpf, prior_bw, mpf_lr, mpf_sigma, th_s, om_s, a_cl, th2,
        om2, a.rk.dt, a.half3g, a.log_space);
    dust_mpf::episode_stein_loop(sx0, sx1, mpf_w, m_mpf,
                                 a.mpf_steps, mk, dust_mpf::PendulumLik{mk});
    clk.mark(kClkMpf);
    if (tid == 0) {
      if (rank == 0) {
        float* row = a.log + (static_cast<size_t>(b) * a.steps + step) * 6;
        row[0] = th2;
        row[1] = om2;
        row[2] = sv[4];
        row[3] = sv[9];
        row[4] = sv[3];
        row[5] = bw_mpf;
      }
      sv[0] = th2;
      sv[1] = om2;
      sv[2] = bw_mpf;
    }
    __syncthreads();
    clk.mark(kClkLog);
  }
  if constexpr (kCluster) {
    // no block leaves while another may still read its pair costs
    cg::this_cluster().sync();
    if (rank != 0) return;
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
  // a single episode takes a cluster of kK4Cluster blocks; a sweep one
  // block per episode
  auto kernel = B == 1 ? pendulum_episode_kernel<kClock, true>
                       : pendulum_episode_kernel<kClock, false>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B == 1 ? kK4Cluster : B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kK4Cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = B == 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// B episodes, one block each: K4 launches B = 1, K5 B = groups x chains x
// scenarios. Arguments: see EpisodeArgs. Device pointers, float32 (ep_i
// int32), contiguous; aseq, pdz and pdu may be null (no a_seq term;
// device-RNG mode). Constants folded by the caller in double precision:
// xmax = 8 dt, cg = -3 g_model 0.5 dt, ca = 3 dt, half3g = 3 g_model 0.5,
// gs = -3 g_sim 0.5, log_n_act = log(n_act). clock, when not null, is
// [B, kClockSlots] int64: the launch then takes the build of the kernel
// that times the phases of a step (the other build has no clock code).
extern "C" int dust_pendulum_episodes(
    const float *scal, const float *ep_f, const int *ep_i,
    const float *theta0, const float *locs0, const float *amat0,
    const float *aseq, const float *mpfx0, float *eps, const float *pdz,
    const float *pdu, float *log, float *theta_out, float *locs_out,
    float *amat_out, float *mpfx_out, long long *clock, int B, int steps,
    int warm_up, int hz, int m, int n_params, int n_act, int m_mpf,
    int mpf_steps, float dt, float xmax, float cg, float ca, float half3g,
    float gs, float log_n_act, int exp_util, int log_space, int fixed_bw,
    float mpf_fixed_bw, float mpf_bw_scale, int host_noise, void *stream) {
  EpisodeArgs a{scal, ep_f, ep_i, theta0, locs0, amat0, aseq, mpfx0, eps,
                pdz, pdu, log, theta_out, locs_out, amat_out, mpfx_out,
                clock, steps, warm_up, hz, m, n_params, n_act, m_mpf,
                mpf_steps, RolloutConsts{dt, xmax, cg, ca}, half3g, gs, log_n_act,
                exp_util, log_space, fixed_bw, mpf_fixed_bw, mpf_bw_scale,
                host_noise};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return clock != nullptr ? launch<true>(B, a, s) : launch<false>(B, a, s);
}
