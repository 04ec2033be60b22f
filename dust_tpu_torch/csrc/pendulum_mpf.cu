// The whole MPF optimize loop for the pendulum dynamics posterior: n_steps
// SVGD iterations on m (length, mass) particles in one launch (K2).
//
// Replaces the TPU kernel `fused_pendulum_mpf_optimize`
// (dust_tpu/ops/pallas_mpf.py, `_mpf_kernel`).
//
// Each iteration, for every particle row i:
//   * GMM prior score over the fixed centers with an isotropic bandwidth
//     (max-subtracted softmax over the centers);
//   * the hand-derived gradient of the Gaussian observation likelihood
//     through one pendulum step, with the speed-clip gate and the
//     log-space chain rule;
//   * the RBF Stein direction in its folded drive form
//     phi_i = (sum_j k_ij (s_j - x_j/bw^2) + (sum_j k_ij) x_i/bw^2) / m;
//   * SGD: x_i += lr * phi_i.
//
// Bound on this card: at the main-path shapes (m = 50, 20 steps) the
// kernel moves ~1.2 KB and does ~1.4 MFLOP, far below a microsecond of
// either; it is bound by the latency of its 20 dependent iterations, each
// a pass over m centers and m particles with one block barrier.
// Design: one block of ceil(8 m / 32) * 32 threads (at most 1024) that
// owns its SM, a group of kLanes = 8 lanes per particle row (400 threads
// at m = 50; measured against 4 and 16), each lane walking every 8th
// column, the group's sums meeting in a butterfly. Up to kRegMax = 64
// particles (the register path, stein_loop_reg in pendulum_mpf.cuh) each
// group holds its row and each lane its centers and squared distances in
// registers, so an iteration's chain is a short walk over registers, one
// over the shared particles and drive terms (float2 each), and one
// barrier; its divisions by the prior weight sum and by m take the
// reciprocal and one corrected product (stein.cuh:div_rn), which measured
// a quarter of K2's time below the division routine. At m = 50 the
// register path took 0.0318 ms against 0.0430 for the shared-memory loop
// at 8 lanes with the same divisions and the same bits, the difference all
// in the prior score (16.8 against 27.4 us of a call; NVIDIA H100 80GB
// HBM3 at 700 W, chip_compare.py); unrolling its columns branch-free took
// it to 0.0299 ms (the same card). Above that the general path (stein_loop,
// the episode kernels' loop at all but 49-52 particles) keeps particles
// and centers in shared memory. The arithmetic
// follows the plain PyTorch version operation by operation, the order of
// the sums too (built with --fmad=false, expf/sinf at full precision).

#include <cuda_runtime.h>

#include "pendulum_mpf.cuh"
#include "phase_clock.cuh"

namespace {

using dust_mpf::kClkLoad;
using dust_mpf::kClkPhases;
using dust_mpf::kClkStore;
using dust_mpf::MpfConsts;

// lanes per particle row (ops/mpf.py:ROW_LANES)
constexpr int kLanes = 8;
// the register path's ceiling: m <= kRegMax, kRegMax / kLanes columns per
// lane (ops/mpf.py:REGISTER_MAX)
constexpr int kRegMax = 64;

template <bool kReg, bool kClock>
__global__ void __launch_bounds__(kReg ? kLanes * kRegMax : 1024, 1)
pendulum_mpf_kernel(
    const float* __restrict__ x_in, const float* __restrict__ centers,
    const float* __restrict__ scal, float* __restrict__ x_out, int m,
    int n_steps, float dt, float half3g, int log_space,
    long long* __restrict__ clock) {
  extern __shared__ __align__(16) float sh[];
  __shared__ long long clk_acc[kClkPhases];
  dust_clock::PhaseClock<kClock, kClkPhases> clk(clk_acc);
  // scal: [bw, prior_bw, lr, sigma, theta0, theta_d0, action, loc0, loc1]
  const MpfConsts k = dust_mpf::mpf_consts(
      m, scal[0], scal[1], scal[2], scal[3], scal[4], scal[5], scal[6],
      scal[7], scal[8], dt, half3g, log_space);
  if constexpr (kReg) {
    // [2, m] particles and drive terms
    float4* xt = reinterpret_cast<float4*>(sh);
    dust_mpf::stein_loop_reg<kLanes, kRegMax / kLanes, 0>(
        dust_mpf::PairIo{x_in, centers, x_out}, xt, m, n_steps, k,
        dust_mpf::PendulumLik{k}, clk);
  } else {
    float* sx0 = sh;          // particles, column 0 (length)
    float* sx1 = sh + m;      // particles, column 1 (mass)
    float* sc0 = sh + 2 * m;  // prior centers
    float* sc1 = sh + 3 * m;
    float* st0 = sh + 4 * m;  // drive terms s_j - x_j / bw^2
    float* st1 = sh + 5 * m;
    float* sn0 = sh + 6 * m;  // the new particles
    float* sn1 = sh + 7 * m;
    float* su0 = sh + 8 * m;
    float* su1 = sh + 9 * m;
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      sx0[i] = x_in[2 * i];
      sx1[i] = x_in[2 * i + 1];
      sc0[i] = centers[2 * i];
      sc1[i] = centers[2 * i + 1];
    }
    __syncthreads();
    clk.mark(kClkLoad);
    dust_mpf::stein_loop<kLanes>(sx0, sx1, sc0, sc1, st0, st1, sn0, sn1,
                                 su0, su1, m, n_steps, k,
                                 dust_mpf::PendulumLik{k}, clk);
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      x_out[2 * i] = sx0[i];
      x_out[2 * i + 1] = sx1[i];
    }
    clk.mark(kClkStore);
  }
  clk.write(clock);
}

template <bool kClock>
int launch(const float* x, const float* centers, const float* scal,
           float* x_out, int m, int n_steps, float dt, float half3g,
           int log_space, long long* clock, cudaStream_t stream) {
  if (m < 1 || m > 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = min(1024, ((kLanes * m + 31) / 32) * 32);
  if (m <= kRegMax) {
    pendulum_mpf_kernel<true, kClock>
        <<<1, threads, 8 * static_cast<size_t>(m) * sizeof(float), stream>>>(
            x, centers, scal, x_out, m, n_steps, dt, half3g, log_space,
            clock);
  } else {
    pendulum_mpf_kernel<false, kClock>
        <<<1, threads, 10 * static_cast<size_t>(m) * sizeof(float),
           stream>>>(x, centers, scal, x_out, m, n_steps, dt, half3g,
                     log_space, clock);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, centers, x_out [m, 2]; scal [9] (see the kernel). All device
// pointers, float32, contiguous; 1 <= m <= 1024. half3g = 3 g 0.5.
extern "C" int dust_pendulum_mpf_optimize(const float* x, const float* centers,
                                          const float* scal, float* x_out,
                                          int m, int n_steps, float dt,
                                          float half3g, int log_space,
                                          void* stream) {
  return launch<false>(x, centers, scal, x_out, m, n_steps, dt, half3g,
                       log_space, nullptr, static_cast<cudaStream_t>(stream));
}

// dust_pendulum_mpf_optimize's clocked build: clock [1, kClkPhases + 2] int64
// receives the phases' cycles (load, prior score, drive and update summed
// over the iterations, store; a measurement aid, the outputs are the
// same).
extern "C" int dust_pendulum_mpf_optimize_clock(
    const float* x, const float* centers, const float* scal, float* x_out,
    int m, int n_steps, float dt, float half3g, int log_space,
    long long* clock, void* stream) {
  return launch<true>(x, centers, scal, x_out, m, n_steps, dt, half3g,
                      log_space, clock, static_cast<cudaStream_t>(stream));
}
