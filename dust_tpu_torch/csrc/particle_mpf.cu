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
// bound by the latency of its 20 dependent iterations, each a pass over m
// centers and m particles plus three block barriers.
// Design: one block of up to 1024 threads, a quad of lanes per particle
// row (particle_mpf.cuh), so each lane walks a quarter of the centers and
// particles and the quad meets in two shuffles; particles, centers, drive
// terms and the new particles live in shared memory for the whole loop.

#include <cuda_runtime.h>

#include "particle_mpf.cuh"

namespace {

__global__ void particle_mpf_kernel(const float* __restrict__ x_in,
                                    const float* __restrict__ centers,
                                    const float* __restrict__ scal,
                                    float* __restrict__ x_out, int m,
                                    int n_steps, float max_acc,
                                    float max_speed, int log_space) {
  extern __shared__ float sh[];
  float* sx = sh;          // particles
  float* sc = sh + m;      // prior centers
  float* st = sh + 2 * m;  // drive terms s_j - x_j / bw^2
  float* sn = sh + 3 * m;  // the new particles
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    sx[i] = x_in[i];
    sc[i] = centers[i];
  }
  __syncthreads();
  const dust_particle::MassMpf k{scal[0], scal[1], scal[2], scal[3],
                                 scal[4], scal[5], scal[6], scal[7],
                                 scal[8], scal[9], scal[10]};
  dust_particle::mass_stein_loop(sx, sc, st, sn, m, n_steps, k, max_acc,
                                 max_speed, log_space);
  for (int i = threadIdx.x; i < m; i += blockDim.x) x_out[i] = sx[i];
}

}  // namespace

// x, centers, x_out [m, 1]; scal [11] (particle_mpf.cuh:MassMpf). All
// device pointers, float32, contiguous; 1 <= m <= 1024.
extern "C" int dust_particle_mpf_optimize(const float* x,
                                          const float* centers,
                                          const float* scal, float* x_out,
                                          int m, int n_steps, float max_acc,
                                          float max_speed, int log_space,
                                          void* stream) {
  // a quad of lanes per particle row, up to 1024 threads
  const int threads =
      min(1024, ((dust_particle::kRowLanes * m + 31) / 32) * 32);
  const size_t shmem = 4 * static_cast<size_t>(m) * sizeof(float);
  particle_mpf_kernel<<<1, threads, shmem,
                        static_cast<cudaStream_t>(stream)>>>(
      x, centers, scal, x_out, m, n_steps, max_acc, max_speed, log_space);
  return static_cast<int>(cudaGetLastError());
}
