// The whole MPF optimize loop for the particle task's mass posterior
// (K7): n_steps SVGD iterations on m one-dimensional (log-)mass particles
// in one launch.
//
// Replaces the TPU kernel `fused_particle_mpf_optimize`
// (dust_tpu/ops/pallas_particle_mpf.py, `_particle_mpf_kernel`).
//
// Each iteration, for every particle: the hand-derived gradient of the
// Gaussian observation likelihood through the velocity prediction of one
// acceleration-control step, the GMM prior score over the fixed centers,
// the RBF Stein direction and the SGD update (particle_mpf.cuh). The crash
// factor at the prediction start is folded into `scale` by the caller.
//
// Bound on this card: at the main-path shapes (m = 50, 20 steps) the
// kernel moves ~0.4 KB and does ~0.8 M float32 operations
// (chip_smoke.py:_k7_bound), far below a microsecond of either; it is
// bound by the latency of its 20 dependent iterations.
// Design: one block of ceil(4 m / 32) * 32 threads (at most 1024), a quad
// of lanes per particle row (kRowLanes, K9/K10's order, so the outputs
// keep the parent's bits), each lane walking every 4th column, the quad's
// sums meeting in a butterfly. Up to kRegMax = 64 particles (the demo's
// m = 50) mass_stein_loop_reg, the loop K9/K10 take at 49-52 particles
// with their centers in shared memory: each quad holds its row and each
// lane its centers and squared distances in registers (K2's design), so an
// iteration is a walk over registers, one over the shared (particle,
// drive term) pairs (a float2 per column), and one block barrier, where
// the parent's loop walked shared memory three times and took three
// barriers; its columns are unrolled branch-free (a column past the
// lane's last adds exactly zero), its reciprocals are rcp.rn and its
// quotients go through them (stein.cuh:div_rn), with the IEEE division's
// bits, and its prior-score max takes fmaxf, as K2's. Above that the
// general path: mass_stein_loop (K9/K10's at their other widths) on
// particles and centers in shared memory (a
// one-barrier version of it measured 0.8% faster at m = 1024, a size no
// path runs). The eleven scalars arrive as kernel arguments, each a
// device pointer or a value (MassScalars), so a call launches this kernel
// and nothing else. Measured at m = 50 (NVIDIA H100 80GB HBM3 at 700 W,
// chip_compare.py): 0.0206 ms against the parent's 0.0356-0.0358; K2's 8
// lanes per row were 6% slower than the quad and 2 lanes 15% slower (in
// one dimension the per-row work that a group's lanes repeat outweighs
// the shorter walk); with its columns branch-free (the loop shared with
// K9/K10) 0.0200-0.0203 ms against 0.0208-0.0209 in one call, 80 / 79
// registers where 98 / 90 (13 columns, clocked / timed). The arithmetic
// follows the plain PyTorch version operation by operation, the order of
// the sums too (built with --fmad=false, expf at full precision).

#include <cuda_runtime.h>

#include "particle_mpf.cuh"
#include "phase_clock.cuh"

namespace {

using dust_particle::kMpfClkPhases;
using dust_particle::kRowLanes;
using dust_particle::MassMpf;

// the register path's ceiling: m <= kRegMax, kRegMax / kRowLanes columns
// per lane (ops/particle_mpf.py:REGISTER_MAX); up to kDemoCols * kRowLanes
// particles (the demo's m = 50) the lanes hold kDemoCols columns, so at
// most one of a lane's columns idles where three of 16 did (7% faster at
// m = 50, chip_compare.py)
constexpr int kRegMax = 64;
constexpr int kDemoCols = 13;
// [bw, prior_bw, lr, sigma, v0x, v0y, ax, ay, loc_vx, loc_vy, scale]
// (ops/particle_mpf.py:mpf_scalars)
constexpr int kScalars = 11;

// Scalar e is *ptr[e] where ptr[e] is not null (a device float), else
// val[e]: the caller's device scalars are read in place, with no copy.
struct MassScalars {
  const float* ptr[kScalars];
  float val[kScalars];
};

__device__ __forceinline__ MassMpf read_scalars(const MassScalars& s) {
  float v[kScalars];
#pragma unroll
  for (int e = 0; e < kScalars; ++e)
    v[e] = s.ptr[e] != nullptr ? __ldg(s.ptr[e]) : s.val[e];
  return MassMpf{v[0], v[1], v[2], v[3], v[4], v[5],
                 v[6], v[7], v[8], v[9], v[10]};
}

// m <= kRowLanes * kCols: mass_stein_loop_reg, clocked where kClock.
template <int kCols, bool kClock>
__global__ void __launch_bounds__(kRowLanes * kRegMax, 1)
particle_mpf_reg_kernel(const float* __restrict__ x_in,
                        const float* __restrict__ centers,
                        const MassScalars s, float* __restrict__ x_out,
                        int m, int n_steps, float max_acc, float max_speed,
                        int log_space, long long* __restrict__ clock) {
  extern __shared__ float sh[];
  __shared__ long long clk_acc[kMpfClkPhases];
  dust_clock::PhaseClock<kClock, kMpfClkPhases> clk(clk_acc);
  const MassMpf k = read_scalars(s);
  // [2, m] (particle, drive term) pairs
  float2* xt = reinterpret_cast<float2*>(sh);
  dust_particle::mass_stein_loop_reg<kRowLanes, kCols, 0>(
      dust_particle::MassDeviceIo{x_in, centers, x_out}, xt, m, n_steps, k,
      max_acc, max_speed, log_space, clk);
  clk.write(clock);
}

// Any m up to 1024: the particles and centers in shared memory.
__global__ void __launch_bounds__(1024, 1)
particle_mpf_kernel(const float* __restrict__ x_in,
                    const float* __restrict__ centers, const MassScalars s,
                    float* __restrict__ x_out, int m, int n_steps,
                    float max_acc, float max_speed, int log_space) {
  extern __shared__ float sh[];
  float* sx = sh;          // particles
  float* sc = sh + m;      // prior centers
  float* st = sh + 2 * m;  // drive terms s_j - x_j / bw^2
  float* sn = sh + 3 * m;  // the new particles
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    sx[i] = x_in[i];
    sc[i] = centers[i];
  }
  const MassMpf k = read_scalars(s);
  __syncthreads();
  dust_particle::mass_stein_loop(sx, sc, st, sn, m, n_steps, k, max_acc,
                                 max_speed, log_space);
  for (int i = threadIdx.x; i < m; i += blockDim.x) x_out[i] = sx[i];
}

template <bool kClock>
int launch(const float* x, const float* centers, const void* scal_ptrs,
           const float* scal_vals, float* x_out, int m, int n_steps,
           float max_acc, float max_speed, int log_space, long long* clock,
           cudaStream_t stream) {
  if (m < 1 || m > 1024) return static_cast<int>(cudaErrorInvalidValue);
  MassScalars s;
  const float* const* ptrs = static_cast<const float* const*>(scal_ptrs);
  for (int e = 0; e < kScalars; ++e) {
    s.ptr[e] = ptrs[e];
    s.val[e] = scal_vals[e];
  }
  const int threads = min(1024, ((kRowLanes * m + 31) / 32) * 32);
  const size_t shmem = 4 * static_cast<size_t>(m) * sizeof(float);
  if (m <= kRowLanes * kDemoCols) {
    particle_mpf_reg_kernel<kDemoCols, kClock>
        <<<1, threads, shmem, stream>>>(x, centers, s, x_out, m, n_steps,
                                        max_acc, max_speed, log_space, clock);
  } else if (m <= kRegMax) {
    particle_mpf_reg_kernel<kRegMax / kRowLanes, kClock>
        <<<1, threads, shmem, stream>>>(x, centers, s, x_out, m, n_steps,
                                        max_acc, max_speed, log_space, clock);
  } else if (kClock) {  // the clocked build times the register path
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    particle_mpf_kernel<<<1, threads, shmem, stream>>>(
        x, centers, s, x_out, m, n_steps, max_acc, max_speed, log_space);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, centers, x_out [m, 1] device pointers, float32, contiguous; 1 <= m
// <= 1024. scal_ptrs: a host array of kScalars device pointers (null where
// the value comes from scal_vals), scal_vals: a host array of kScalars
// floats, both in mpf_scalars' order.
extern "C" int dust_particle_mpf_optimize(const float* x,
                                          const float* centers,
                                          const void* scal_ptrs,
                                          const float* scal_vals,
                                          float* x_out, int m, int n_steps,
                                          float max_acc, float max_speed,
                                          int log_space, void* stream) {
  return launch<false>(x, centers, scal_ptrs, scal_vals, x_out, m, n_steps,
                       max_acc, max_speed, log_space, nullptr,
                       static_cast<cudaStream_t>(stream));
}

// dust_particle_mpf_optimize's clocked build, for m <= kRegMax: clock [1,
// kMpfClkPhases + 2] int64 receives the phases' cycles (load, prior score,
// drive and update summed over the iterations, store; a measurement aid,
// the outputs are the same).
extern "C" int dust_particle_mpf_optimize_clock(
    const float* x, const float* centers, const void* scal_ptrs,
    const float* scal_vals, float* x_out, int m, int n_steps, float max_acc,
    float max_speed, int log_space, long long* clock, void* stream) {
  return launch<true>(x, centers, scal_ptrs, scal_vals, x_out, m, n_steps,
                      max_acc, max_speed, log_space, clock,
                      static_cast<cudaStream_t>(stream));
}
