// One whole particle-navigation SVMPC solve in one launch (K8).
//
// Replaces the TPU kernel `fused_particle_solve`
// (dust_tpu/ops/pallas_solve.py, `_particle_solve_kernel` and
// `_solve_tail` with dim_a 2).
//
// One solve: all n_params x m x n_act point-mass rollouts with obstacle
// collisions (particle.cuh, K6's step) -> param-averaged costs -> DISCO
// softmax weights, a_mat / a_mix update -> likelihood gradient, GMM prior
// score with the weighted mixture's log-weights, RBF Stein step, SGD ->
// posterior weights, first-argmax selection, "repeat" roll by one step
// (two values) -> outputs. Noise, mass draws and the Silverman bandwidth
// are inputs. The particles are rows of hz * 2 values (the horizon
// flattened), so the softmaxes and the Stein step are K3's device code
// (stein.cuh).
//
// Bound on this card: at the main-path shapes (4 x 6 x 64 rollouts,
// H = 40, m = 6) the kernel moves ~137 KB (the actions 123 KB of it) and
// does ~8 M float32 operations (chip_smoke.py:_k8_bound): well under a
// microsecond of either. It is bound by the latency of its dependent
// phases (a 40-step rollout chain, then a dozen short reductions separated
// by barriers).
// Design: a thread-block cluster of m blocks of 256 threads, block q on
// policy particle q, so the solve spreads over m SMs. Block q stages the
// model and its particle's actions in shared memory, rolls out the
// particle's n_params x n_act trajectories one per thread (one round at
// the demo's 4 x 64; particle.cuh:trajectory_cost) and adds each pair's
// draws in draw order (stein.cuh:sum_draws), so the costs equal the plain
// version's bit for bit. The DISCO softmax needs the min over all rows:
// each block publishes its row's min and reads the others' over
// distributed shared memory. Block q then takes its row's softmax (one
// warp) and its row's delta and likelihood gradient, kSumLanes lanes per
// entry. The Stein step needs every row: after a cluster barrier block 0
// copies the other rows' scores and log-likelihoods over distributed
// shared memory, the other blocks finish, and block 0 takes the step (K3's
// device code, stein.cuh) and writes the outputs (measured faster than
// every block taking the step and writing its row).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "particle.cuh"
#include "phase_clock.cuh"
#include "stein.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace dust_solve;
using dust_particle::kModelFloats;

// lanes that share one entry's sum over the action samples in the delta
// (ops/solve.py:SUM_LANES)
constexpr int kSumLanes = 8;

// The phases of the solve that the clocked build of the kernel times
// (ops/solve.py:CLOCK_PHASES, phase_clock.cuh).
enum : int {
  kClkLoad = 0, kClkRollouts, kClkDisco, kClkDelta, kClkStein, kClkOutputs,
  kClkPhases,
  kClockSlots = kClkPhases + 2
};

// shared floats of one block: the model, theta/locs/score/theta_new of
// every row, the particle's actions (rows of ev + 1: no bank conflicts
// between neighbouring samples), the draw costs, the row's costs and
// softmaxes, the Stein scratch and the scalars
__host__ __device__ inline size_t solve_smem_floats(int m, int ev,
                                                    int n_act,
                                                    int n_params) {
  return kModelFloats + 4 * static_cast<size_t>(m) * ev +
         static_cast<size_t>(n_act) * (ev + 1) +
         static_cast<size_t>(n_params) * n_act + 3 * static_cast<size_t>(n_act) +
         3 * kMaxM * kMaxM + 5 * kMaxM + kMaxParams + 4 + 2 * kWarps + 8 +
         2;
}

template <bool kClock>
__global__ void __launch_bounds__(kThreads, 1) particle_solve_kernel(
    const float* __restrict__ model, const float* __restrict__ scal,
    const float* __restrict__ theta_in, const float* __restrict__ locs_in,
    const float* __restrict__ log_mix, const float* __restrict__ amat,
    const float* __restrict__ aseq, const float* __restrict__ actions,
    const float* __restrict__ masses, float* __restrict__ theta_opt,
    float* __restrict__ theta_fwd, float* __restrict__ amat_out,
    float* __restrict__ a_mix, float* __restrict__ aseq_sel,
    float* __restrict__ weights, float* __restrict__ costs, int hz, int m,
    int n_params, int n_act, float log_n_act, int exp_util,
    long long* __restrict__ clock) {
  extern __shared__ float sh[];
  __shared__ long long clk_acc[kClkPhases];
  dust_clock::PhaseClock<kClock, kClkPhases> clk(clk_acc);
  cg::cluster_group cluster = cg::this_cluster();
  const int q = static_cast<int>(cluster.block_rank());  // this particle
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int ev = 2 * hz;
  const int mh = m * ev;
  const int ast = ev + 1;
  float* km = sh;
  float* theta = km + kModelFloats;
  float* locs = theta + mh;
  float* score = locs + mh;
  float* theta_new = score + mh;
  float* acts = theta_new + mh;              // [n_act, ev + 1]
  float* dcost = acts + n_act * ast;         // [n_params, n_act]
  float* mcost = dcost + n_params * n_act;   // row q [n_act]
  float* omega = mcost + n_act;
  float* w_lik = omega + n_act;
  SteinSmem ss;
  ss.lp = w_lik + n_act;
  ss.r = ss.lp + kMaxM * kMaxM;
  ss.kmat = ss.r + kMaxM * kMaxM;
  ss.rowsum = ss.kmat + kMaxM * kMaxM;
  ss.log_w = ss.rowsum + kMaxM;
  ss.weights = ss.log_w + kMaxM;
  float* eta = ss.weights + kMaxM;           // every row's, in the end
  float* log_l = eta + kMaxM;
  float* im = log_l + kMaxM;
  float* s0 = im + kMaxParams;
  float* red = s0 + 4;                       // 2 * kWarps + 8
  ss.i_star = reinterpret_cast<int*>(red + 2 * kWarps + 8);
  float* row_min = red + 2 * kWarps + 9;     // read by the other blocks

  // scal: [x, y, vx, vy, bw, lr, alpha, temp, ctrl_sigma, prior_sigma]
  const float bw = scal[4], lr = scal[5];
  const float inv_s2 = 1.0f / (scal[8] * scal[8]);
  const float inv_ps2 = 1.0f / (scal[9] * scal[9]);
  const DiscoConsts dk{1.0f / scal[7], scal[6], log_n_act,
                       static_cast<float>(1.0 / n_act), exp_util};
  for (int e = tid; e < mh; e += nt) {
    theta[e] = theta_in[e];
    locs[e] = locs_in[e];
  }
  // actions [n_act, m, hz, 2]: particle q's rows (unrolled: the loads of
  // eight iterations are in flight together)
#pragma unroll 8
  for (int e = tid; e < n_act * ev; e += nt) {
    const int i = e / ev;
    acts[i * ast + (e - i * ev)] = actions[(i * m + q) * ev + (e - i * ev)];
  }
  if (tid < n_params) im[tid] = 1.0f / masses[tid];
  if (tid < 4) s0[tid] = scal[tid];
  dust_particle::load_model(model, km);  // synchronises the block
  clk.mark(kClkLoad);

  // ---- rollouts: one (draw, sample) trajectory per thread in turn, then
  // each sample's draws summed in draw order ----
  for (int u = tid; u < n_params * n_act; u += nt) {
    const int p = u / n_act;
    const float* ai = acts + (u - p * n_act) * ast;
    dcost[u] = dust_particle::trajectory_cost(
        km, s0[0], s0[1], s0[2], s0[3], im[p], hz,
        [&](int t) { return make_float2(ai[2 * t], ai[2 * t + 1]); },
        [&](int, float2 v, float& ax, float& ay) {
          ax = v.x;
          ay = v.y;
        });
  }
  __syncthreads();
  sum_draws(dcost, n_params, n_act, mcost);
  __syncthreads();
  for (int i = tid; i < n_act; i += nt) costs[i * m + q] = mcost[i];
  clk.mark(kClkRollouts);

  // ---- DISCO weights of row q, against the min over every row ----
  block_min(mcost, n_act, red, row_min);
  cluster.sync();  // every block's row min is published
  if (tid < 32) {
    float beta = tid < m ? *cluster.map_shared_rank(row_min, tid) : INFINITY;
    beta = warp_min(beta);
    disco_row(mcost, n_act, beta, dk, omega, w_lik, eta + q, log_l + q);
  }
  __syncthreads();
  clk.mark(kClkDisco);

  // ---- delta_q = sum_i omega[i] (a[i, q, :] - a_seq); the likelihood
  // gradient (sum_i w[i] a[i, q, :] - theta_q) / sigma^2; kSumLanes lanes
  // per entry, lane s taking the samples i = s, s + kSumLanes, ..., then a
  // butterfly in a fixed order ----
  {
    const int sub = tid % kSumLanes;
    const unsigned mask = lane_group_mask(kSumLanes);
    for (int l = tid / kSumLanes; l < ev; l += nt / kSumLanes) {
      const float as = aseq[l];
      float d = 0.0f, wa = 0.0f;
      for (int i = sub; i < n_act; i += kSumLanes) {
        const float av = acts[i * ast + l];
        d = d + omega[i] * (av - as);
        wa = wa + w_lik[i] * av;
      }
      d = lane_group_sum<kSumLanes>(d, mask);
      wa = lane_group_sum<kSumLanes>(wa, mask);
      if (sub == 0) {
        const int e = q * ev + l;
        amat_out[e] = amat[e] + d;
        score[e] = (wa - theta[e]) * inv_s2;
      }
    }
  }
  cluster.sync();  // every row's score, eta and log_l are published
  clk.mark(kClkDelta);

  // ---- every row's score, eta and log_l into block 0 over distributed
  // shared memory; the other blocks are done ----
  if (q == 0) {
    for (int e = ev + tid; e < mh; e += nt)
      score[e] = cluster.map_shared_rank(score, e / ev)[e];
    if (tid > 0 && tid < m) {
      eta[tid] = cluster.map_shared_rank(eta, tid)[tid];
      log_l[tid] = cluster.map_shared_rank(log_l, tid)[tid];
    }
  }
  cluster.sync();  // no block leaves while block 0 reads its memory
  if (q != 0) return;

  // ---- Stein step + forward ----
  stein_forward(theta, locs, score, log_mix, 1, log_l, m, ev, bw, lr,
                inv_ps2, ss, theta_new);
  clk.mark(kClkStein);
  const int star = *ss.i_star;
  for (int e = tid; e < mh; e += nt) {
    const int l = e % ev;
    theta_opt[e] = theta_new[e];
    // "repeat" roll by one step of two values; the last step repeats
    theta_fwd[e] = l < ev - 2 ? theta_new[e + 2] : theta_new[e];
  }
  for (int l = tid; l < ev; l += nt)
    aseq_sel[l] = star < m ? theta_new[star * ev + l] : 0.0f;
  if (tid < m) weights[tid] = ss.weights[tid];
  if (tid == 32) {
    float emax = -INFINITY;
    for (int r = 0; r < m; ++r) emax = maxp(emax, eta[r]);
    float se = 0.0f;
    for (int r = 0; r < m; ++r) se = se + expf(eta[r] - emax);
    for (int r = 0; r < m; ++r) a_mix[r] = expf(eta[r] - emax) / se;
  }
  clk.mark(kClkOutputs);
  clk.write(clock);
}

template <bool kClock>
int launch_solve(const float* model, const float* scal, const float* theta,
                 const float* locs, const float* log_mix, const float* amat,
                 const float* aseq, const float* actions, const float* masses,
                 float* theta_opt, float* theta_fwd, float* amat_out,
                 float* a_mix, float* aseq_sel, float* weights, float* costs,
                 int hz, int m, int n_params, int n_act, float log_n_act,
                 int exp_util, long long* clock, cudaStream_t stream) {
  if (m < 1 || m > kMaxM || n_params < 1 || n_params > kMaxParams ||
      hz < 1 || n_act < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes =
      solve_smem_floats(m, 2 * hz, n_act, n_params) * sizeof(float);
  auto kernel = particle_solve_kernel<kClock>;
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
      &cfg, kernel, model, scal, theta, locs, log_mix, amat, aseq, actions,
      masses, theta_opt, theta_fwd, amat_out, a_mix, aseq_sel, weights, costs,
      hz, m, n_params, n_act, log_n_act, exp_util, clock);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// model: ops/particle_rollout.py:model_tensor; scal [10]: x, y, vx, vy,
// bw, lr, alpha, temp, ctrl_sigma, prior_sigma. theta/locs/amat/theta_opt/
// theta_fwd/amat_out [m, hz, 2]; log_mix, a_mix, weights [m]; aseq,
// aseq_sel [hz, 2]; actions [n_act, m, hz, 2]; masses [n_params]; costs
// [n_act, m]. All device pointers, float32, contiguous; m <= 8,
// n_params <= 8. log_n_act = log(n_act), folded by the caller.
extern "C" int dust_particle_solve(
    const float* model, const float* scal, const float* theta,
    const float* locs, const float* log_mix, const float* amat,
    const float* aseq, const float* actions, const float* masses,
    float* theta_opt, float* theta_fwd, float* amat_out, float* a_mix,
    float* aseq_sel, float* weights, float* costs, int hz, int m,
    int n_params, int n_act, float log_n_act, int exp_util, void* stream) {
  return launch_solve<false>(
      model, scal, theta, locs, log_mix, amat, aseq, actions, masses,
      theta_opt, theta_fwd, amat_out, a_mix, aseq_sel, weights, costs, hz, m,
      n_params, n_act, log_n_act, exp_util, nullptr,
      static_cast<cudaStream_t>(stream));
}

// dust_particle_solve's clocked build: clock [1, kClockSlots] int64
// receives block 0's phase cycles, which span the whole solve (a
// measurement aid; the outputs are the same).
extern "C" int dust_particle_solve_clock(
    const float* model, const float* scal, const float* theta,
    const float* locs, const float* log_mix, const float* amat,
    const float* aseq, const float* actions, const float* masses,
    float* theta_opt, float* theta_fwd, float* amat_out, float* a_mix,
    float* aseq_sel, float* weights, float* costs, int hz, int m,
    int n_params, int n_act, float log_n_act, int exp_util,
    long long* clock, void* stream) {
  return launch_solve<true>(
      model, scal, theta, locs, log_mix, amat, aseq, actions, masses,
      theta_opt, theta_fwd, amat_out, a_mix, aseq_sel, weights, costs, hz, m,
      n_params, n_act, log_n_act, exp_util, clock,
      static_cast<cudaStream_t>(stream));
}
