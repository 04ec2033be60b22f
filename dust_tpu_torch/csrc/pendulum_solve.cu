// One whole pendulum SVMPC solve in one launch (K3).
//
// Replaces the TPU kernel `fused_pendulum_solve`
// (dust_tpu/ops/pallas_solve.py, `_pendulum_solve_kernel` and
// `_solve_tail`).
//
// One solve: all n_params x m x n_act rollouts (state (cos th, sin th, om)
// advanced by plane rotation) -> param-averaged costs -> DISCO softmax
// weights, a_mat / a_mix update -> likelihood gradient, GMM prior score,
// RBF Stein step, SGD -> posterior weights, first-argmax selection,
// "repeat" roll. Noise, parameter draws and the Silverman bandwidth are
// inputs.
//
// Bound on this card: at the main-path shapes (8 x 3 x 128 rollouts,
// H = 30, m = 3) the kernel moves ~50 KB (mostly the actions) and does
// ~3.3 M float32 operations (chip_smoke.py:_k3_bound): well under a
// microsecond of either. It is bound by the latency of its dependent
// phases (a 30-step rollout chain, then a dozen short reductions
// separated by barriers).
// Design (K8's, particle_solve.cu, then measured phase by phase with the
// clocked build): a thread-block cluster of m blocks of 256 threads, block
// q on policy particle q, so the solve spreads over m SMs. Block q rolls
// out its n_act <= 128 pairs in one round on warps 0-3, each thread
// carrying the states of all n_params draws in registers
// (pendulum_solve.cuh:rollout_mcost, the draws added in draw order, so the
// costs keep their bits) and reading its sample's actions from device
// memory one step ahead; each thread keeps the actions it read in shared
// memory for the delta (rows of hz + 1: no bank conflicts between
// neighbouring samples; staging them before the rollouts measured slower
// than the rollouts' own latency-hidden reads); meanwhile warps 4-7
// of block 0 take the half of the Stein step that needs only the inputs
// (the prior logits, the RBF kernel matrix and the prior responsibilities
// of every particle pair). The DISCO softmax needs the min over every
// row: warp 0 publishes its row's min and arrives at a split cluster
// barrier, warp 1 takes the row's likelihood softmax while the barrier
// completes, then warp 0 reads the other rows' mins over distributed
// shared memory and takes the row's DISCO softmax. The row's delta and
// likelihood gradient take kSumLanes lanes per entry; every block writes
// its score row, eta and log-likelihood straight into block 0's shared
// memory, and after one cluster barrier block 0 alone finishes the Stein
// step (the new particles' logits kSumLanes lanes per pair) and writes the
// outputs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "pendulum_solve.cuh"
#include "phase_clock.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace dust_solve;

// lanes that share one entry's sum over the action samples in the delta,
// and one pair's sum over the horizon in the new particles' logits
// (ops/solve.py:SUM_LANES)
constexpr int kSumLanes = 8;
// the threads that roll out the samples (n_act <= 128); the other warps of
// block 0 take the first half of the Stein step meanwhile
constexpr int kRolloutThreads = 128;

// The phases of the solve that the clocked build of the kernel times
// (ops/solve.py:CLOCK_PHASES, phase_clock.cuh).
enum : int {
  kClkLoad = 0, kClkRollouts, kClkDisco, kClkDelta, kClkStein, kClkOutputs,
  kClkPhases
};

// Cluster barrier in two halves: arrive (release: this thread's earlier
// shared-memory writes become visible to the cluster), then wait
// (acquire). Every thread of every block calls both.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// shared floats of one block: theta/locs/score/theta_new of every row,
// the particle's actions (rows of hz + 1), the row's costs and softmaxes,
// the Stein scratch and the scalars
__host__ __device__ inline size_t solve_smem_floats(int m, int hz,
                                                    int n_act) {
  return 4 * static_cast<size_t>(m) * hz +
         static_cast<size_t>(n_act) * (hz + 1) +
         3 * static_cast<size_t>(n_act) + 3 * kMaxM * kMaxM + 5 * kMaxM +
         2 * kMaxParams + 2;
}

template <bool kClock>
__global__ void __launch_bounds__(kThreads, 1) pendulum_solve_kernel(
    const float* __restrict__ scal, const float* __restrict__ theta_in,
    const float* __restrict__ locs_in, const float* __restrict__ log_mix,
    const float* __restrict__ amat, const float* __restrict__ aseq,
    const float* __restrict__ actions, const float* __restrict__ lengths,
    const float* __restrict__ masses, float* __restrict__ theta_opt,
    float* __restrict__ theta_fwd, float* __restrict__ amat_out,
    float* __restrict__ a_mix, float* __restrict__ aseq_sel,
    float* __restrict__ weights, float* __restrict__ costs, int hz, int m,
    int n_params, int n_act, RolloutConsts rk, float log_n_act,
    int exp_util, long long* __restrict__ clock) {
  extern __shared__ float sh[];
  __shared__ long long clk_acc[kClkPhases];
  dust_clock::PhaseClock<kClock, kClkPhases> clk(clk_acc);
  cg::cluster_group cluster = cg::this_cluster();
  const int q = static_cast<int>(cluster.block_rank());  // this particle
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int mh = m * hz;
  const int ast = hz + 1;
  float* theta = sh;
  float* locs = theta + mh;
  float* score = locs + mh;
  float* theta_new = score + mh;
  float* acts = theta_new + mh;            // [n_act, hz + 1]
  float* mcost = acts + n_act * ast;       // row q [n_act]
  float* omega = mcost + n_act;
  float* w_lik = omega + n_act;
  SteinSmem ss;
  ss.lp = w_lik + n_act;
  ss.r = ss.lp + kMaxM * kMaxM;
  ss.kmat = ss.r + kMaxM * kMaxM;
  ss.rowsum = ss.kmat + kMaxM * kMaxM;
  ss.log_w = ss.rowsum + kMaxM;
  ss.weights = ss.log_w + kMaxM;
  float* eta = ss.weights + kMaxM;         // every row's, in the end
  float* log_l = eta + kMaxM;
  float* il = log_l + kMaxM;
  float* im = il + kMaxParams;
  ss.i_star = reinterpret_cast<int*>(im + kMaxParams);
  float* row_min = im + kMaxParams + 1;    // read by the other blocks

  // scal: [th0, om0, bw, lr, alpha, temp, ctrl_sigma, prior_sigma]
  const float th0 = scal[0], om0 = scal[1], bw = scal[2], lr = scal[3];
  const float inv_s2 = 1.0f / (scal[6] * scal[6]);
  const float inv_ps2 = 1.0f / (scal[7] * scal[7]);
  const DiscoConsts dk{1.0f / scal[5], scal[4], log_n_act,
                       static_cast<float>(1.0 / n_act), exp_util};
  for (int e = tid; e < mh; e += nt) {
    theta[e] = theta_in[e];
    locs[e] = locs_in[e];
  }
  if (tid < n_params) {
    il[tid] = 1.0f / lengths[tid];
    im[tid] = 1.0f / masses[tid];
  }
  __syncthreads();
  clk.mark(kClkLoad);

  // ---- rollouts: sample i on thread i of warps 0-3, its draws in
  // registers, its actions read from device memory one step ahead and
  // kept in shared memory for the delta; warps 4-7 of block 0 take the
  // first half of the Stein step meanwhile ----
  if (tid < kRolloutThreads)
    rollout_mcost(th0, om0, il, im, n_params, 0, n_act, hz, n_act, rk,
                  [&](int, int i, int t) {
                    return actions[(i * m + q) * hz + t];
                  },
                  [&](int, int t, float raw) {
                    acts[tid * ast + t] = raw;  // one pair per thread
                    return raw;
                  },
                  mcost);
  else if (q == 0)
    stein_prior(theta, locs, log_mix, 1, m, hz, bw, inv_ps2, ss,
                kRolloutThreads / 32, (nt - kRolloutThreads) / 32);
  __syncthreads();
  for (int i = tid; i < n_act; i += nt) costs[i * m + q] = mcost[i];
  clk.mark(kClkRollouts);

  // ---- DISCO weights of row q, against the min over every row; the
  // likelihood softmax needs no min and fills the barrier's wait. Row q's
  // eta and log-likelihood go straight to block 0 ----
  float* const eta0 = cluster.map_shared_rank(eta, 0);
  float* const log_l0 = cluster.map_shared_rank(log_l, 0);
  const int warp = tid >> 5;
  if (warp == 0) {
    float mn = INFINITY;
    for (int i = tid; i < n_act; i += 32) mn = minp(mn, mcost[i]);
    mn = warp_min(mn);
    if (tid == 0) *row_min = mn;
  }
  cluster_arrive();  // every block's row min is published
  if (warp == 1) lik_row(mcost, n_act, dk, w_lik, log_l + q);
  cluster_wait();  // and every block has started: block 0's memory is live
  if (tid == 32) log_l0[q] = log_l[q];
  if (warp == 0) {
    float beta = tid < m ? *cluster.map_shared_rank(row_min, tid) : INFINITY;
    beta = warp_min(beta);
    omega_row(mcost, n_act, beta, dk, omega, eta0 + q);
  }
  __syncthreads();
  clk.mark(kClkDisco);

  // ---- delta_q = sum_i omega[i] (a[i, q, :] - a_seq); the likelihood
  // gradient (sum_i w[i] a[i, q, :] - theta_q) / sigma^2, into block 0's
  // score rows; kSumLanes lanes per entry, lane s taking the samples
  // i = s, s + kSumLanes, ..., then a butterfly in a fixed order. The four
  // groups of a warp take entries kWarps apart, so their reads of the
  // action rows meet no bank twice ----
  {
    float* const score0 = cluster.map_shared_rank(score, 0);
    const int sub = tid % kSumLanes;
    const int ent = (tid >> 5) + kWarps * ((tid & 31) / kSumLanes);
    const unsigned mask = lane_group_mask(kSumLanes);
    for (int t = ent; t < hz; t += nt / kSumLanes) {
      const float as = aseq[t];
      float d = 0.0f, wa = 0.0f;
      for (int i = sub; i < n_act; i += kSumLanes) {
        const float av = acts[i * ast + t];
        d = d + omega[i] * (av - as);
        wa = wa + w_lik[i] * av;
      }
      d = lane_group_sum<kSumLanes>(d, mask);
      wa = lane_group_sum<kSumLanes>(wa, mask);
      if (sub == 0) {
        const int e = q * hz + t;
        amat_out[e] = amat[e] + d;
        score0[e] = (wa - theta[e]) * inv_s2;
      }
    }
  }
  // every row's score, eta and log_l are in block 0; the other blocks are
  // done (nothing reads their shared memory any more)
  cluster.sync();
  clk.mark(kClkDelta);
  if (q != 0) return;

  // ---- the rest of the Stein step + forward ----
  stein_tail<kSumLanes>(theta, locs, score, log_mix, 1, log_l, m, hz, bw, lr,
                        inv_ps2, ss, theta_new);
  clk.mark(kClkStein);
  const int star = *ss.i_star;
  for (int e = tid; e < mh; e += nt) {
    const int r = e / hz;
    const int t = e - r * hz;
    theta_opt[e] = theta_new[e];
    theta_fwd[e] = theta_new[r * hz + min(t + 1, hz - 1)];
  }
  for (int t = tid; t < hz; t += nt)
    aseq_sel[t] = star < m ? theta_new[star * hz + t] : 0.0f;
  if (tid < m) weights[tid] = ss.weights[tid];
  if (tid == 32) {
    float emax = -INFINITY;
    for (int r = 0; r < m; ++r) emax = maxp(emax, eta[r]);
    float se = 0.0f;
    for (int r = 0; r < m; ++r) se = se + expf(eta[r] - emax);
    const float ise = 1.0f / se;
    for (int r = 0; r < m; ++r)
      a_mix[r] = div_rn(expf(eta[r] - emax), se, ise);
  }
  clk.mark(kClkOutputs);
  clk.write(clock);
}

template <bool kClock>
int launch_solve(const float* scal, const float* theta, const float* locs,
                 const float* log_mix, const float* amat, const float* aseq,
                 const float* actions, const float* lengths,
                 const float* masses, float* theta_opt, float* theta_fwd,
                 float* amat_out, float* a_mix, float* aseq_sel,
                 float* weights, float* costs, int hz, int m, int n_params,
                 int n_act, const RolloutConsts& rk, float log_n_act,
                 int exp_util, long long* clock, cudaStream_t stream) {
  if (m < 1 || m > kMaxM || n_params < 1 || n_params > kMaxParams ||
      hz < 1 || n_act < 1 || n_act > kRolloutThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = solve_smem_floats(m, hz, n_act) * sizeof(float);
  auto kernel = pendulum_solve_kernel<kClock>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // one cluster of m blocks (m <= 8: a portable cluster size)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(m);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = m;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, scal, theta, locs, log_mix, amat, aseq, actions, lengths,
      masses, theta_opt, theta_fwd, amat_out, a_mix, aseq_sel, weights, costs,
      hz, m, n_params, n_act, rk, log_n_act, exp_util, clock);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// scal [8]: th0, om0, bw, lr, alpha, temp, ctrl_sigma, prior_sigma.
// theta/locs/amat/theta_opt/theta_fwd/amat_out [m, hz]; log_mix, a_mix,
// weights [m]; aseq, aseq_sel [hz]; actions [n_act, m, hz];
// lengths/masses [n_params]; costs [n_act, m]. All device pointers,
// float32, contiguous; m <= 8, n_params <= 8, n_act <= 128. cg = -3 g 0.5 dt,
// ca = 3 dt, xmax = 8 dt, log_n_act = log(n_act), folded by the caller.
extern "C" int dust_pendulum_solve(
    const float* scal, const float* theta, const float* locs,
    const float* log_mix, const float* amat, const float* aseq,
    const float* actions, const float* lengths, const float* masses,
    float* theta_opt, float* theta_fwd, float* amat_out, float* a_mix,
    float* aseq_sel, float* weights, float* costs, int hz, int m,
    int n_params, int n_act, float dt, float xmax, float cg, float ca,
    float log_n_act, int exp_util, void* stream) {
  return launch_solve<false>(
      scal, theta, locs, log_mix, amat, aseq, actions, lengths, masses,
      theta_opt, theta_fwd, amat_out, a_mix, aseq_sel, weights, costs, hz, m,
      n_params, n_act, RolloutConsts{dt, xmax, cg, ca}, log_n_act, exp_util,
      nullptr, static_cast<cudaStream_t>(stream));
}

// dust_pendulum_solve's clocked build: clock [1, kClkPhases + 2] int64
// receives block 0's phase cycles, which span the whole solve (a
// measurement aid; the outputs are the same).
extern "C" int dust_pendulum_solve_clock(
    const float* scal, const float* theta, const float* locs,
    const float* log_mix, const float* amat, const float* aseq,
    const float* actions, const float* lengths, const float* masses,
    float* theta_opt, float* theta_fwd, float* amat_out, float* a_mix,
    float* aseq_sel, float* weights, float* costs, int hz, int m,
    int n_params, int n_act, float dt, float xmax, float cg, float ca,
    float log_n_act, int exp_util, long long* clock, void* stream) {
  return launch_solve<true>(
      scal, theta, locs, log_mix, amat, aseq, actions, lengths, masses,
      theta_opt, theta_fwd, amat_out, a_mix, aseq_sel, weights, costs, hz, m,
      n_params, n_act, RolloutConsts{dt, xmax, cg, ca}, log_n_act, exp_util,
      clock, static_cast<cudaStream_t>(stream));
}
