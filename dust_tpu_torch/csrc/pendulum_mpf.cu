// The whole MPF optimize loop for the pendulum dynamics posterior: n_steps
// SVGD iterations on m (length, mass) particles in one launch.
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
// a pass over m centers and m particles plus three block barriers.
// Design: one block of ceil(4m/32)*32 threads (at most 1024), a quad of
// lanes per particle row, each lane walking a quarter of the columns and
// the quad's sums meeting in a butterfly; particles, centers, the per-row
// drive terms and the new particles live in shared memory for the whole
// loop, so nothing returns to device memory between iterations. The loop
// itself is `dust_mpf::stein_loop` (pendulum_mpf.cuh), which the
// whole-episode kernel runs too. The arithmetic follows the plain PyTorch
// version operation by operation, the order of the sums too (built with
// --fmad=false, expf/sinf at full precision).

#include <cuda_runtime.h>

#include "pendulum_mpf.cuh"

namespace {

__global__ void pendulum_mpf_kernel(const float* __restrict__ x_in,
                                    const float* __restrict__ centers,
                                    const float* __restrict__ scal,
                                    float* __restrict__ x_out, int m,
                                    int n_steps, float dt, float half3g,
                                    int log_space) {
  extern __shared__ float sh[];
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
  // scal: [bw, prior_bw, lr, sigma, theta0, theta_d0, action, loc0, loc1]
  dust_mpf::stein_loop(sx0, sx1, sc0, sc1, st0, st1, sn0, sn1, su0, su1, m,
                       n_steps, scal[0], scal[1], scal[2], scal[3], scal[4],
                       scal[5], scal[6], scal[7], scal[8], dt, half3g,
                       log_space);
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    x_out[2 * i] = sx0[i];
    x_out[2 * i + 1] = sx1[i];
  }
}

}  // namespace

// x, centers, x_out [m, 2]; scal [9] (see the kernel). All device
// pointers, float32, contiguous; 1 <= m <= 1024. half3g = 3 g 0.5.
extern "C" int dust_pendulum_mpf_optimize(const float* x, const float* centers,
                                          const float* scal, float* x_out,
                                          int m, int n_steps, float dt,
                                          float half3g, int log_space,
                                          void* stream) {
  // a quad of lanes per particle row, up to 1024 threads
  const int threads = min(1024, ((dust_mpf::kRowLanes * m + 31) / 32) * 32);
  const size_t shmem = 10 * static_cast<size_t>(m) * sizeof(float);
  pendulum_mpf_kernel<<<1, threads, shmem,
                        static_cast<cudaStream_t>(stream)>>>(
      x, centers, scal, x_out, m, n_steps, dt, half3g, log_space);
  return static_cast<int>(cudaGetLastError());
}
