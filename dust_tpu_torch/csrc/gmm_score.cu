// The streamed GMM prior score (K12) of MPF's uniform-mixture prior
// around k centers with isotropic bandwidth bw:
//
//   score_i = sum_k r_ik (c_k - x_i) / bw^2,
//   r_ik = softmax_k(-|x_i - c_k|^2 / (2 bw^2)),
//
// as an online softmax over the centers: per row a running max, normalizer
// and weighted sum of the shifted centers (stream_tiles.cuh), so the
// [m, k] responsibilities are never stored.
//
// Replaces the TPU kernels `gmm_prior_score_pallas` (`_score_kernel`) and
// `gmm_prior_score_pallas_packed` (`_score_kernel_packed`) of
// dust_tpu/ops/pallas_gmm.py; both wrappers (ops/gmm.py) launch this
// kernel. The TPU carries the running state across a sequential grid of
// center blocks; here one thread per row walks all centers.
//
// Bound on this card: per (row, center) pair 5d + 4 float32 operations
// (the distance 3d, the scale, the max test, exp, the normalizer and the
// d weighted sums, each a multiply and an add) against reading x and the centers once and writing the
// score once: operations bound (chip_smoke.py:_k12_bound).
// Design: as svgd_phi.cu, 128 rows per block for d <= 8, the running max
// rescales the sums only when it grows.

#include <math.h>

#include <cuda_runtime.h>

#include "stream_tiles.cuh"

namespace {

using namespace dust_stream;

template <int D>
__global__ void __launch_bounds__(block_rows<D>())
    gmm_score_kernel(const float* __restrict__ x,
                     const float* __restrict__ centers,
                     const float* __restrict__ bw, float* __restrict__ out,
                     int m, int kc, int d_rt, int bf16) {
  extern __shared__ float sh[];
  const int d = D > 0 ? D : d_rt;
  const Tiles t = carve<D>(sh, d);
  RowVecs<D> v = begin_rows<D>(x, m, d, t, nullptr, centers);
  const float b = bw[0];
  const float inv2 = 0.5f / (b * b);
  float mx = -INFINITY, l = 0.0f;
  gmm_sums<D>(centers, kc, d, inv2, bf16 != 0, t, v, mx, l);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
#pragma unroll
  for (int dd = 0; dd < (D > 0 ? D : d); ++dd) {
    const float mean_c = v.at(1, dd) / l;
    out[static_cast<size_t>(i) * d + dd] =
        (mean_c - (v.at(0, dd) - t.shift_b[dd])) * (2.0f * inv2);
  }
}

template <int D>
struct GmmLaunch {
  static int run(int m, int d, cudaStream_t stream, const float* x,
                 const float* centers, const float* bw, float* out, int kc,
                 int bf16) {
    dim3 grid, block;
    size_t bytes;
    const int rc = configure<D>(gmm_score_kernel<D>, m, d, &grid, &block,
                                &bytes);
    if (rc != 0) return rc;
    gmm_score_kernel<D><<<grid, block, bytes, stream>>>(x, centers, bw, out,
                                                        m, kc, d, bf16);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

// x, out [m, d]; centers [kc, d]; bw [1] the prior bandwidth. Device
// pointers, float32, contiguous. d <= 128; bf16 (round the weights p and
// the shifted centers to bf16 before the products) only for d <= 8.
extern "C" int dust_gmm_score(const float* x, const float* centers,
                              const float* bw, float* out, int m, int kc,
                              int d, int bf16, void* stream) {
  if (m < 1 || kc < 1 || (bf16 && d > 8))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_for_d<GmmLaunch>(m, d, static_cast<cudaStream_t>(stream), x,
                                 centers, bw, out, kc, bf16);
}
