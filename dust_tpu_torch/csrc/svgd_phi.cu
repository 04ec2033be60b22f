// The streamed SVGD direction (K11) for large particle counts:
//
//   phi_i = (sum_j K_ij score_j + sum_j K_ij (x_i - x_j) / bw^2) / m,
//   K_ij = exp(-|x_i - x_j|^2 / (2 bw^2)),
//
// without storing K.
//
// Replaces the TPU kernels `svgd_phi_pallas` (`_phi_kernel`),
// `svgd_phi_pallas_packed` (`_phi_kernel_packed`) and
// `svgd_phi_pallas_symm` (`_phi_kernel_packed_symm`) of
// dust_tpu/ops/pallas_svgd.py: all three compute the same function, and
// all three wrappers (ops/svgd.py) launch this kernel. The TPU carries the
// row block's sums across a sequential grid of column blocks; here the
// columns are split across the warps of a thread-block cluster and the
// sums merged in a fixed order. The symmetric TPU kernel evaluates only
// the j >= i tiles and mirrors them, which on a GPU needs atomics across
// blocks: not taken.
//
// Bound on this card: per particle pair 7d + 3 float32 operations (the
// distance 3d, the scale, exp, the row sum and the 2d product sums, each a
// multiply and an add) against reading x and score once and writing phi
// once: operations bound at every m this path sees (chip_smoke.py:
// _k11_bound). At m = 8192, d = 2 that is ~1.1 G operations, ~17 us; the
// exp unit's 16 ex2 per clock per SM bounds it about as tightly.
//
// Design, d <= 8 (stream_split.cuh:phi_sums, the walk K13's first half
// runs too): a cluster of up to 8 blocks of 8 warps owns a tile of 32 or
// 64 rows, and every warp walks its own slice of the particles, staged
// once with cp.async, so at m = 2048 the grid is 512 blocks, not 16. In
// float32 phi_i = (sum_j K_ij score_j + sum_j K_ij (x_i - x_j) / bw^2) / m
// takes the differences the distance already formed, so it needs no shift
// and no row sum; K_ij is one ex2 (log2 e folded into the scale), the sums
// explicit fmas. bf16 rounds K, the scores and x_j - x_0 before the
// products and keeps the row sum:
//   phi_i = (sum_j K score_j + (rowsum_i (x_i - x_0)
//            - sum_j K (x_j - x_0)) / bw^2) / m.
// The warps' sums merge in warp order, then the cluster's in rank order
// through distributed shared memory; each block writes its share of the
// tile's rows. No atomics, the same bits every call.
// d > 8 (on no path but the general entry's tests) keeps one thread per
// row walking column tiles of 32 (stream_tiles.cuh:svgd_sums).

#include <cuda_runtime.h>

#include "stream_split.cuh"
#include "stream_tiles.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace dust_split;

template <int D, int RPT, bool BF16>
__global__ void __launch_bounds__(kThreads, 2)
    svgd_split_kernel(const float* __restrict__ x,
                      const float* __restrict__ score,
                      const float* __restrict__ bw, float* __restrict__ phi,
                      int m, int width, int qe, int nbuf) {
  constexpr int R = 32 * RPT;
  constexpr int F = PhiSums<D, BF16>::kFloats;
  constexpr int NC = PhiSums<D, BF16>::kArrays;
  extern __shared__ float sh[];
  cg::cluster_group cluster = cg::this_cluster();
  const Place pl = place<RPT>(cluster, m, width);
  float* stage = sh + pl.warp * nbuf * NC * qe * D;
  float* part = sh + kWarps * nbuf * NC * qe * D;  // [kWarps][R][F]
  float* blk = part + kWarps * R * F;               // [R][F]
  const float b = bw[0];
  const float inv2 = 0.5f / (b * b);
  float acc[F];
  phi_sums<D, RPT, BF16>(cluster, pl, x, score, m, inv2 * kLog2e, stage, qe,
                         part, F, blk, acc);
  const int r = threadIdx.x;
  const int i = pl.row0 + r;
  if (r < R && i < m && r / (R / pl.cluster) == pl.rank) {
    const float inv_m = 1.0f / static_cast<float>(m);
#pragma unroll
    for (int dd = 0; dd < D; ++dd) {
      const float xi = x[static_cast<size_t>(i) * D + dd];
      float drive = acc[dd], repel;
      if constexpr (BF16)
        repel = (acc[2 * D] * (xi - x[dd]) - acc[D + dd]) * (2.0f * inv2);
      else
        repel = acc[D + dd] * (2.0f * inv2);
      phi[static_cast<size_t>(i) * D + dd] = (drive + repel) * inv_m;
    }
  }
  cluster.sync();  // the other blocks have read this block's sums
}

template <int D, int RPT, bool BF16>
int launch_split(const Geometry& g, cudaStream_t stream, const float* x,
                 const float* score, const float* bw, float* phi, int m) {
  return launch(svgd_split_kernel<D, RPT, BF16>, g, stream, x, score, bw,
                phi, m, g.width, g.qe, g.nbuf);
}

template <int D>
int launch_d(int m, int bf16, cudaStream_t stream, const float* x,
             const float* score, const float* bw, float* phi) {
  const int nc = bf16 ? PhiSums<D, true>::kArrays : PhiSums<D, false>::kArrays;
  const int f = bf16 ? PhiSums<D, true>::kFloats : PhiSums<D, false>::kFloats;
  const Geometry g = geometry<D>(m, m, nc, (kWarps + 1) * f);
  if (bf16)
    return g.rpt == 2 ? launch_split<D, 2, true>(g, stream, x, score, bw, phi, m)
                      : launch_split<D, 1, true>(g, stream, x, score, bw, phi, m);
  return g.rpt == 2 ? launch_split<D, 2, false>(g, stream, x, score, bw, phi, m)
                    : launch_split<D, 1, false>(g, stream, x, score, bw, phi, m);
}

// d > 8: one thread per row, 64 rows per block, the rows' vectors in
// shared memory
__global__ void __launch_bounds__(dust_stream::kRowsWide)
    svgd_wide_kernel(const float* __restrict__ x,
                     const float* __restrict__ score,
                     const float* __restrict__ bw, float* __restrict__ phi,
                     int m, int d) {
  using namespace dust_stream;
  extern __shared__ float sh[];
  const Tiles t = carve(sh, d);
  RowVecs v = begin_rows(x, m, d, t, x, nullptr);
  const float b = bw[0];
  const float inv2 = 0.5f / (b * b);
  float rows = 0.0f;
  svgd_sums(x, score, m, d, inv2, t, v, rows);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const float inv_m = 1.0f / static_cast<float>(m);
  for (int dd = 0; dd < d; ++dd) {
    const float repel =
        (rows * (v.at(0, dd) - t.shift_a[dd]) - v.at(2, dd)) * (2.0f * inv2);
    phi[static_cast<size_t>(i) * d + dd] = (v.at(1, dd) + repel) * inv_m;
  }
}

int launch_wide(const float* x, const float* score, const float* bw,
                float* phi, int m, int d, cudaStream_t stream) {
  dim3 grid, block;
  size_t bytes;
  const int rc = dust_stream::configure(svgd_wide_kernel, m, d, &grid,
                                        &block, &bytes);
  if (rc != 0) return rc;
  svgd_wide_kernel<<<grid, block, bytes, stream>>>(x, score, bw, phi, m, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, score, phi [m, d]; bw [1] the kernel bandwidth. Device pointers,
// float32, contiguous. d <= 128; bf16 (round K, the scores and the
// shifted particles to bf16 before the products) only for d <= 8.
extern "C" int dust_svgd_phi(const float* x, const float* score,
                             const float* bw, float* phi, int m, int d,
                             int bf16, void* stream) {
  if (m < 1 || d < 1 || d > dust_stream::kMaxWideD || (bf16 && d > 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: return launch_d<1>(m, bf16, s, x, score, bw, phi);
    case 2: return launch_d<2>(m, bf16, s, x, score, bw, phi);
    case 3: return launch_d<3>(m, bf16, s, x, score, bw, phi);
    case 4: return launch_d<4>(m, bf16, s, x, score, bw, phi);
    case 5: return launch_d<5>(m, bf16, s, x, score, bw, phi);
    case 6: return launch_d<6>(m, bf16, s, x, score, bw, phi);
    case 7: return launch_d<7>(m, bf16, s, x, score, bw, phi);
    case 8: return launch_d<8>(m, bf16, s, x, score, bw, phi);
    default: return launch_wide(x, score, bw, phi, m, d, s);
  }
}
