// The streamed GMM prior score (K12) of MPF's uniform-mixture prior
// around k centers with isotropic bandwidth bw:
//
//   score_i = sum_k r_ik (c_k - x_i) / bw^2,
//   r_ik = softmax_k(-|x_i - c_k|^2 / (2 bw^2)),
//
// as an online softmax over the centers (running max, normalizer and
// weighted sum of the shifted centers), so the [m, k] responsibilities
// are never stored.
//
// Replaces the TPU kernels `gmm_prior_score_pallas` (`_score_kernel`) and
// `gmm_prior_score_pallas_packed` (`_score_kernel_packed`) of
// dust_tpu/ops/pallas_gmm.py; both wrappers (ops/gmm.py) launch this
// kernel. The TPU carries the running state across a sequential grid of
// center blocks.
//
// Bound on this card: per (row, center) pair 5d + 4 float32 operations
// against reading x and the centers once and writing the score once:
// operations bound (chip_smoke.py:_k12_bound); the exp unit's 16 ex2 per
// clock per SM bounds it about as tightly (~16 us at m = k = 8192).
//
// Design, d <= 8 (stream_split.cuh): a cluster of up to 8 blocks of 8
// warps owns a tile of 32 or 64 rows, and every warp walks its own slice
// of the centers, so at m = 2048 the grid is 512 blocks, not 16; each warp
// stages its slice once with cp.async and walks it with no block barrier;
// per tile of 16 centers the distances stay in registers, the state is
// rescaled once and the weights are one ex2 each (log2 e folded into the
// scale), multiply-adds explicit fmas (the library's --fmad=false stays
// for K1, K6 and K8); the partial states merge in a fixed order over the
// warps and then over the cluster through distributed shared memory, so
// no atomics and the same bits every call. No tensor cores: the products
// are d <= 8 deep, and bf16 or tf32 operands would break the f32
// tolerances. d > 8 (on no path) keeps one thread per row walking tiles of
// 32 centers (stream_tiles.cuh:gmm_sums).

#include <math.h>

#include <cuda_runtime.h>

#include "stream_split.cuh"
#include "stream_tiles.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace dust_split;

template <int D, int RPT>
__global__ void __launch_bounds__(kThreads, 2)
    gmm_split_kernel(const float* __restrict__ x,
                     const float* __restrict__ centers,
                     const float* __restrict__ bw, float* __restrict__ out,
                     int m, int kc, int width, int qe, int nbuf, int bf16) {
  extern __shared__ float sh[];
  cg::cluster_group cluster = cg::this_cluster();
  const Place pl = place<RPT>(cluster, kc, width);
  const int nb = bf16 ? 2 : 1;
  float* stage = sh + pl.warp * nbuf * nb * qe * D;
  float* part = sh + kWarps * nbuf * nb * qe * D;
  float* blk = part + kWarps * 32 * RPT * (D + 2);
  const float b = bw[0];
  const float inv2 = 0.5f / (b * b);
  const float s2 = inv2 * kLog2e;
  float c0[D];
#pragma unroll
  for (int dd = 0; dd < D; ++dd) c0[dd] = centers[dd];
  float xr[RPT][D];
  Soft<D> st[RPT];
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const int i = pl.row0 + q * 32 + pl.lane;
#pragma unroll
    for (int dd = 0; dd < D; ++dd)
      xr[q][dd] = i < m ? x[static_cast<size_t>(i) * D + dd] - c0[dd] : 0.0f;
    soft_clear(st[q]);
  }
  const float* src[1] = {centers};
  walk_slice<D, 1>(
      src, pl.j0, pl.j1, stage, nb, qe, pl.lane,
      [&](float* buf, int col) {
#pragma unroll
        for (int dd = 0; dd < D; ++dd) {
          const float v = buf[col * D + dd] - c0[dd];
          buf[col * D + dd] = v;
          if (bf16) buf[qe * D + col * D + dd] = bf16_round(v);
        }
      },
      [&](const float* buf, int n) {
        soft_walk<D, RPT>(buf, bf16 ? buf + qe * D : buf, n, xr, s2,
                          bf16 != 0, st);
      });
  Soft<D> fin;
  int i;
  if (soft_reduce<D, RPT>(cluster, pl, st, part, blk, s2, fin, i) && i < m) {
#pragma unroll
    for (int dd = 0; dd < D; ++dd) {
      const float xc = x[static_cast<size_t>(i) * D + dd] - c0[dd];
      out[static_cast<size_t>(i) * D + dd] =
          (fin.acc[dd] / fin.l - xc) * (2.0f * inv2);
    }
  }
  cluster.sync();  // the other blocks have read this block's states
}

template <int D>
int launch_split(const float* x, const float* centers, const float* bw,
                 float* out, int m, int kc, int bf16, cudaStream_t stream) {
  const Geometry g = geometry<D>(m, kc, bf16 ? 2 : 1, (kWarps + 1) * (D + 2));
  if (g.rpt == 2)
    return launch(gmm_split_kernel<D, 2>, g, stream, x, centers, bw, out, m,
                  kc, g.width, g.qe, g.nbuf, bf16);
  return launch(gmm_split_kernel<D, 1>, g, stream, x, centers, bw, out, m,
                kc, g.width, g.qe, g.nbuf, bf16);
}

// d > 8: one thread per row, 64 rows per block, the rows' vectors in
// shared memory
__global__ void __launch_bounds__(dust_stream::kRowsWide)
    gmm_wide_kernel(const float* __restrict__ x,
                    const float* __restrict__ centers,
                    const float* __restrict__ bw, float* __restrict__ out,
                    int m, int kc, int d) {
  using namespace dust_stream;
  extern __shared__ float sh[];
  const Tiles t = carve(sh, d);
  RowVecs v = begin_rows(x, m, d, t, nullptr, centers);
  const float b = bw[0];
  const float inv2 = 0.5f / (b * b);
  float mx = -INFINITY, l = 0.0f;
  gmm_sums(centers, kc, d, inv2, t, v, mx, l);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  for (int dd = 0; dd < d; ++dd) {
    const float mean_c = v.at(1, dd) / l;
    out[static_cast<size_t>(i) * d + dd] =
        (mean_c - (v.at(0, dd) - t.shift_b[dd])) * (2.0f * inv2);
  }
}

int launch_wide(const float* x, const float* centers, const float* bw,
                float* out, int m, int kc, int d, cudaStream_t stream) {
  dim3 grid, block;
  size_t bytes;
  const int rc = dust_stream::configure(gmm_wide_kernel, m, d, &grid,
                                        &block, &bytes);
  if (rc != 0) return rc;
  gmm_wide_kernel<<<grid, block, bytes, stream>>>(x, centers, bw, out, m,
                                                  kc, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out [m, d]; centers [kc, d]; bw [1] the prior bandwidth. Device
// pointers, float32, contiguous. d <= 128; bf16 (round the weights p and
// the shifted centers to bf16 before the products, f32 sums; each weight
// against the running max of its warp's slice at tile granularity, see
// ops/gmm.py:gmm_prior_score_plain) only for d <= 8.
extern "C" int dust_gmm_score(const float* x, const float* centers,
                              const float* bw, float* out, int m, int kc,
                              int d, int bf16, void* stream) {
  if (m < 1 || kc < 1 || d < 1 || d > dust_stream::kMaxWideD ||
      (bf16 && d > 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: return launch_split<1>(x, centers, bw, out, m, kc, bf16, s);
    case 2: return launch_split<2>(x, centers, bw, out, m, kc, bf16, s);
    case 3: return launch_split<3>(x, centers, bw, out, m, kc, bf16, s);
    case 4: return launch_split<4>(x, centers, bw, out, m, kc, bf16, s);
    case 5: return launch_split<5>(x, centers, bw, out, m, kc, bf16, s);
    case 6: return launch_split<6>(x, centers, bw, out, m, kc, bf16, s);
    case 7: return launch_split<7>(x, centers, bw, out, m, kc, bf16, s);
    case 8: return launch_split<8>(x, centers, bw, out, m, kc, bf16, s);
    default: return launch_wide(x, centers, bw, out, m, kc, d, s);
  }
}
