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
// Bound on this card: per particle pair 5d + 3 float32 operations (the
// distance 3d, the scale, exp, the row sum and one multiply-add per
// dimension of sum_j K_ij (score_j - 2 x_j / bw^2), the repulsion folded
// into that column operand), plus 8 per element of x, against reading x
// and score once and writing phi once: operations bound at every m this
// path sees (chip_smoke.py:_k11_bound). At m = 8192, d = 2 that is ~0.87 G
// operations, ~13 us; the exp unit's 16 ex2 per clock per SM gives ~16 us,
// a tighter bound that _k11_bound does not count.
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
// 8 < d <= 128 keeps one thread per row walking column tiles of 32
// (stream_tiles.cuh:svgd_sums). Above d = 128 (an MPF over many
// parameters) a block of 16 rows walks column tiles of 32 and the
// dimensions in chunks of 128 (stream_dchunk.cuh): the distances in
// registers, then K once per pair, then the chunks again for
// sum_j K_ij (score_j - (x_j - x_0) / bw^2), the tile's terms summed apart
// and added to the row's running sums in phi itself; the last pass adds
// rowsum_i (x_i - x_0) / bw^2 and divides by m. The repulsion is folded
// into that column operand, so a pair costs the distance, K and one
// multiply-add per dimension; the columns are read once per 16 rows.

#include <cuda_runtime.h>

#include "stream_dchunk.cuh"
#include "stream_split.cuh"
#include "stream_tiles.cuh"

namespace {

namespace cg = cooperative_groups;
namespace dc = dust_dchunk;
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

// d > 128: a block per 16 rows, the dimensions in chunks of 128
__global__ void __launch_bounds__(dust_dchunk::kThreads)
    svgd_dchunk_kernel(const float* __restrict__ x,
                       const float* __restrict__ score,
                       const float* __restrict__ bw, float* __restrict__ phi,
                       int m, int d) {
  __shared__ dc::Smem sm;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * dc::kRows;
  const int ia = row0 + 2 * warp;
  const int ib = ia + 1;
  const float b = bw[0];
  const float inv2 = 0.5f / (b * b);
  const float two = 2.0f * inv2;
  float rows_a = 0.0f, rows_b = 0.0f;
  for (int j0 = 0; j0 < m; j0 += dc::kCols) {
    float d2a, d2b;
    dc::distances(x, m, x, m, j0, d, row0, sm, d2a, d2b);
    const bool valid = j0 + lane < m;
    const float ka = valid ? expf(-d2a * inv2) : 0.0f;
    const float kb = valid ? expf(-d2b * inv2) : 0.0f;
    rows_a = rows_a + dc::warp_sum(ka);
    rows_b = rows_b + dc::warp_sum(kb);
    for (int c0 = 0; c0 < d; c0 += dc::kChunk) {
      const int nd = min(dc::kChunk, d - c0);
      __syncthreads();  // the previous chunk has been read
      // the column operand score_j - (x_j - x_0) / bw^2
      for (int jj = warp; jj < dc::kCols; jj += dc::kWarps) {
        const int j = j0 + jj;
        for (int dd = lane; dd < dc::kChunk; dd += 32) {
          float w = 0.0f;
          if (j < m && dd < nd) {
            const size_t e = static_cast<size_t>(j) * d + c0 + dd;
            w = score[e] - two * (x[e] - x[c0 + dd]);
          }
          sm.col[jj * dc::kPitch + dd] = w;
        }
      }
      __syncthreads();
      float ta[dc::kPer], tb[dc::kPer];
      dc::tile_sums(sm, ka, kb, ta, tb);
      dc::add_tile(phi, ia, m, d, c0, nd, 1.0f, j0 == 0, ta);
      dc::add_tile(phi, ib, m, d, c0, nd, 1.0f, j0 == 0, tb);
    }
  }
  const float inv_m = 1.0f / static_cast<float>(m);
  for (int q = 0; q < 2; ++q) {
    const int i = q == 0 ? ia : ib;
    const float rows = q == 0 ? rows_a : rows_b;
    if (i >= m) continue;
    for (int dd = lane; dd < d; dd += 32) {
      const size_t e = static_cast<size_t>(i) * d + dd;
      phi[e] = (phi[e] + rows * (x[e] - x[dd]) * two) * inv_m;
    }
  }
}

int launch_dchunk(const float* x, const float* score, const float* bw,
                  float* phi, int m, int d, cudaStream_t stream) {
  const int blocks = (m + dc::kRows - 1) / dc::kRows;
  svgd_dchunk_kernel<<<blocks, dc::kThreads, 0, stream>>>(x, score, bw, phi,
                                                           m, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, score, phi [m, d]; bw [1] the kernel bandwidth. Device pointers,
// float32, contiguous. Any d; bf16 (round K, the scores and the shifted
// particles to bf16 before the products) only for d <= 8.
extern "C" int dust_svgd_phi(const float* x, const float* score,
                             const float* bw, float* phi, int m, int d,
                             int bf16, void* stream) {
  if (m < 1 || d < 1 || (bf16 && d > 8))
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
    default:
      return d <= dust_stream::kMaxWideD
                 ? launch_wide(x, score, bw, phi, m, d, s)
                 : launch_dchunk(x, score, bw, phi, m, d, s);
  }
}
