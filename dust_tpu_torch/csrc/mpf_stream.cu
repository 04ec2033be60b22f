// One FusedMPF SVGD iteration and the next iteration's prior score in one
// launch (K13):
//
//   x_new = x + lr * phi(x, score)          (K11's phi, bandwidth bw)
//   gp_new = gmm_score(x_new, centers, pbw)  (K12's score, bandwidth pbw)
//
// Replaces the TPU kernel `fused_mpf_stream_step`
// (dust_tpu/ops/pallas_mpf_stream.py, `_stream_step_kernel`). The TPU
// kernel pipelines the two streams one row block apart on its sequential
// grid, carrying the finished x_new block in scratch. On a GPU no
// pipeline is needed: gp_new of a row depends only on that row's x_new and
// on the fixed centers, so each block finishes phi for its rows, keeps
// x_new in registers, writes it, and then streams the centers against it.
// No block waits on another.
//
// Bound on this card: the sum of K11's and K12's operation counts at
// k == m (chip_smoke.py:_k13_bound), operations bound.
// Design: svgd_phi.cu's then gmm_score.cu's loop in one block of 128 rows,
// d <= 8 in registers, float32 only.

#include <math.h>

#include <cuda_runtime.h>

#include "stream_tiles.cuh"

namespace {

using namespace dust_stream;

template <int D>
__global__ void __launch_bounds__(kRows)
    mpf_stream_kernel(const float* __restrict__ x,
                      const float* __restrict__ score,
                      const float* __restrict__ centers,
                      const float* __restrict__ scal,
                      float* __restrict__ x_new, float* __restrict__ gp_new,
                      int m) {
  extern __shared__ float sh[];
  const Tiles t = carve<D>(sh, D);
  RowVecs<D> v = begin_rows<D>(x, m, D, t, x, centers);
  const float bw = scal[0], pbw = scal[1], lr = scal[2];
  const float inv2 = 0.5f / (bw * bw);
  const float pinv2 = 0.5f / (pbw * pbw);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;

  // ---- phi for this block's rows, then the SGD step ----
  float rows = 0.0f;
  svgd_sums<D>(x, score, m, D, inv2, false, t, v, rows);
  const float inv_m = 1.0f / static_cast<float>(m);
#pragma unroll
  for (int dd = 0; dd < D; ++dd) {
    const float repel =
        (rows * (v.at(0, dd) - t.shift_a[dd]) - v.at(2, dd)) * (2.0f * inv2);
    const float phi = (v.at(1, dd) + repel) * inv_m;
    v.at(0, dd) = v.at(0, dd) + lr * phi;
    v.at(1, dd) = 0.0f;
    if (i < m) x_new[static_cast<size_t>(i) * D + dd] = v.at(0, dd);
  }

  // ---- the prior score at the new rows ----
  float mx = -INFINITY, l = 0.0f;
  gmm_sums<D>(centers, m, D, pinv2, false, t, v, mx, l);
  if (i >= m) return;
#pragma unroll
  for (int dd = 0; dd < D; ++dd) {
    const float mean_c = v.at(1, dd) / l;
    gp_new[static_cast<size_t>(i) * D + dd] =
        (mean_c - (v.at(0, dd) - t.shift_b[dd])) * (2.0f * pinv2);
  }
}

template <int D>
struct StreamLaunch {
  static int run(int m, int d, cudaStream_t stream, const float* x,
                 const float* score, const float* centers, const float* scal,
                 float* x_new, float* gp_new) {
    dim3 grid, block;
    size_t bytes;
    const int rc = configure<D>(mpf_stream_kernel<D>, m, d, &grid, &block,
                                &bytes);
    if (rc != 0) return rc;
    mpf_stream_kernel<D><<<grid, block, bytes, stream>>>(
        x, score, centers, scal, x_new, gp_new, m);
    return static_cast<int>(cudaGetLastError());
  }
};

template <>
struct StreamLaunch<0> {
  static int run(int, int, cudaStream_t, const float*, const float*,
                 const float*, const float*, float*, float*) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
};

}  // namespace

// x, score, x_new, gp_new [m, d]; centers [m, d] (the prior is centered on
// the particles); scal [3] = (bw, pbw, lr). Device pointers, float32,
// contiguous; 1 <= d <= 8.
extern "C" int dust_mpf_stream_step(const float* x, const float* score,
                                    const float* centers, const float* scal,
                                    float* x_new, float* gp_new, int m,
                                    int d, void* stream) {
  if (m < 1 || d < 1 || d > 8) return static_cast<int>(cudaErrorInvalidValue);
  return launch_for_d<StreamLaunch>(m, d, static_cast<cudaStream_t>(stream),
                                    x, score, centers, scal, x_new, gp_new);
}
