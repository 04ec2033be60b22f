// The streamed SVGD direction (K11) for large particle counts:
//
//   phi_i = (sum_j K_ij score_j
//            + (rowsum(K)_i (x_i - c) - sum_j K_ij (x_j - c)) / bw^2) / m,
//   K_ij = exp(-|x_i - x_j|^2 / (2 bw^2)),
//
// without storing K (c, the first particle, cancels; see stream_tiles.cuh).
//
// Replaces the TPU kernels `svgd_phi_pallas` (`_phi_kernel`),
// `svgd_phi_pallas_packed` (`_phi_kernel_packed`) and
// `svgd_phi_pallas_symm` (`_phi_kernel_packed_symm`) of
// dust_tpu/ops/pallas_svgd.py: all three compute the same function, and
// all three wrappers (ops/svgd.py) launch this kernel. The TPU carries the
// row block's sums across a sequential grid of column blocks; here one
// thread per row walks all columns itself, so the blocks are independent.
// The symmetric TPU kernel evaluates only the j >= i tiles and mirrors
// them, which on a GPU needs atomics across blocks: not taken.
//
// Bound on this card: per particle pair 7d + 3 float32 operations (the
// distance 3d, the scale, exp, the row sum and the 2d product sums, each a
// multiply and an add) against reading x and score once and writing phi
// once: operations bound at every m this path sees (chip_smoke.py:
// _k11_bound). At m = 8192, d = 2 that is ~1.1 G operations, ~17 us.
// Design: 128 rows per block (one thread each) with the row's vectors in
// registers for d <= 8, column tiles of 128 staged in shared memory and
// read as broadcasts; d > 8 keeps the vectors in shared memory. At m =
// 2048 that is 16 blocks on 132 SMs.

#include <cuda_runtime.h>

#include "stream_tiles.cuh"

namespace {

using namespace dust_stream;

template <int D>
__global__ void __launch_bounds__(block_rows<D>())
    svgd_phi_kernel(const float* __restrict__ x,
                    const float* __restrict__ score,
                    const float* __restrict__ bw, float* __restrict__ phi,
                    int m, int d_rt, int bf16) {
  extern __shared__ float sh[];
  const int d = D > 0 ? D : d_rt;
  const Tiles t = carve<D>(sh, d);
  RowVecs<D> v = begin_rows<D>(x, m, d, t, x, nullptr);
  const float b = bw[0];
  const float inv2 = 0.5f / (b * b);
  float rows = 0.0f;
  svgd_sums<D>(x, score, m, d, inv2, bf16 != 0, t, v, rows);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const float inv_m = 1.0f / static_cast<float>(m);
#pragma unroll
  for (int dd = 0; dd < (D > 0 ? D : d); ++dd) {
    const float repel =
        (rows * (v.at(0, dd) - t.shift_a[dd]) - v.at(2, dd)) * (2.0f * inv2);
    phi[static_cast<size_t>(i) * d + dd] = (v.at(1, dd) + repel) * inv_m;
  }
}

template <int D>
struct PhiLaunch {
  static int run(int m, int d, cudaStream_t stream, const float* x,
                 const float* score, const float* bw, float* phi,
                 int bf16) {
    dim3 grid, block;
    size_t bytes;
    const int rc = configure<D>(svgd_phi_kernel<D>, m, d, &grid, &block,
                                &bytes);
    if (rc != 0) return rc;
    svgd_phi_kernel<D><<<grid, block, bytes, stream>>>(x, score, bw, phi, m,
                                                       d, bf16);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

// x, score, phi [m, d]; bw [1] the kernel bandwidth. Device pointers,
// float32, contiguous. d <= 128; bf16 (round K, the scores and the
// shifted particles to bf16 before the products) only for d <= 8.
extern "C" int dust_svgd_phi(const float* x, const float* score,
                             const float* bw, float* phi, int m, int d,
                             int bf16, void* stream) {
  if (m < 1 || (bf16 && d > 8))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_for_d<PhiLaunch>(m, d, static_cast<cudaStream_t>(stream), x,
                                 score, bw, phi, bf16);
}
