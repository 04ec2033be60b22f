// One FusedMPF SVGD iteration and the next iteration's prior score in one
// launch (K13):
//
//   x_new = x + lr * phi(x, score)          (K11's phi, bandwidth bw)
//   gp_new = gmm_score(x_new, centers, pbw)  (K12's score, bandwidth pbw)
//
// Replaces the TPU kernel `fused_mpf_stream_step`
// (dust_tpu/ops/pallas_mpf_stream.py, `_stream_step_kernel`). The TPU
// kernel pipelines the two streams one row block apart on its sequential
// grid, carrying the finished x_new block in scratch. Here no pipeline is
// needed: gp_new of a row depends only on that row's x_new and on the
// fixed centers.
//
// Bound on this card: the sum of K11's and K12's operation counts at
// k == m (chip_smoke.py:_k13_bound), operations bound; the exp unit's 16
// ex2 per clock per SM bounds it about as tightly (~32 us at m = 8192).
//
// Design (stream_split.cuh): a cluster of up to 8 blocks of 8 warps owns a
// tile of 32 or 64 rows, and every warp walks its own slice of the
// particles for phi (phi_sums, the walk K11 runs too), then the same slice
// of the centers for the prior score, each staged once with cp.async.
// phi_i = (sum_j K_ij score_j +
// sum_j K_ij (x_i - x_j) / bw^2) / m takes the differences it already
// forms for the distance, so no shift is needed and no row sum; K_ij is
// one ex2 (log2 e folded into the scale), the sums explicit fmas. The
// warps' phi sums merge over the block, then over the cluster: every block
// reads the cluster's partial sums through distributed shared memory in
// rank order, so all of them hold the same x_new of the tile, and each
// writes its share of it once. The prior-score stream then runs as in
// gmm_score.cu against those rows: one launch, no grid-wide barrier, no
// atomics, the same bits every call. Float32 only (no bf16 option).

#include <math.h>

#include <cuda_runtime.h>

#include "stream_split.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace dust_split;

// floats per row of the merge areas: the larger of phi's 2d sums and the
// softmax state's d + 2
template <int D>
__host__ __device__ constexpr int merge_width() {
  return 2 * D > D + 2 ? 2 * D : D + 2;
}

template <int D, int RPT>
__global__ void __launch_bounds__(kThreads, 2)
    mpf_stream_kernel(const float* __restrict__ x,
                      const float* __restrict__ score,
                      const float* __restrict__ centers,
                      const float* __restrict__ scal,
                      float* __restrict__ x_new, float* __restrict__ gp_new,
                      int m, int width, int qe, int nbuf) {
  constexpr int R = 32 * RPT;
  constexpr int F = merge_width<D>();
  extern __shared__ float sh[];
  cg::cluster_group cluster = cg::this_cluster();
  const Place pl = place<RPT>(cluster, m, width);
  float* stage = sh + pl.warp * nbuf * 2 * qe * D;
  float* part = sh + kWarps * nbuf * 2 * qe * D;   // [kWarps][R][F]
  float* blk_phi = part + kWarps * R * F;           // [R][2D]
  float* blk_gmm = blk_phi + R * 2 * D;             // [R][D + 2]
  float* xn = blk_gmm + R * (D + 2);                // [R][D]
  const float bw = scal[0], pbw = scal[1], lr = scal[2];
  const float inv2 = 0.5f / (bw * bw);
  const float s2 = inv2 * kLog2e;
  const float pinv2 = 0.5f / (pbw * pbw);
  const float ps2 = pinv2 * kLog2e;

  // ---- phi: this warp's slice of the particles, merged over the cluster
  float acc[2 * D];
  phi_sums<D, RPT, false>(cluster, pl, x, score, m, s2, stage, qe, part, F,
                          blk_phi, acc);

  // ---- x_new of the whole tile in every block, its share written once ----
  const float inv_m = 1.0f / static_cast<float>(m);
  if (threadIdx.x < R) {
    const int r = threadIdx.x;
    const int i = pl.row0 + r;
    const int per = R / pl.cluster;
#pragma unroll
    for (int dd = 0; dd < D; ++dd) {
      const float xi = i < m ? x[static_cast<size_t>(i) * D + dd] : 0.0f;
      const float phi = (acc[dd] + acc[D + dd] * (2.0f * inv2)) * inv_m;
      const float v = xi + lr * phi;
      xn[r * D + dd] = v;
      if (i < m && r / per == pl.rank) x_new[static_cast<size_t>(i) * D + dd] = v;
    }
  }
  __syncthreads();

  // ---- the prior score at the new rows: the same slice of the centers ----
  float c0[D];
#pragma unroll
  for (int dd = 0; dd < D; ++dd) c0[dd] = centers[dd];
  float xr[RPT][D];
  Soft<D> st[RPT];
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
#pragma unroll
    for (int dd = 0; dd < D; ++dd)
      xr[q][dd] = xn[(q * 32 + pl.lane) * D + dd] - c0[dd];
    soft_clear(st[q]);
  }
  const float* src_gmm[1] = {centers};
  walk_slice<D, 1>(
      src_gmm, pl.j0, pl.j1, stage, 2, qe, pl.lane,
      [&](float* buf, int col) {
#pragma unroll
        for (int dd = 0; dd < D; ++dd) buf[col * D + dd] -= c0[dd];
      },
      [&](const float* buf, int n) {
        soft_walk<D, RPT>(buf, buf, n, xr, ps2, false, st);
      });
  Soft<D> fin;
  int i;
  if (soft_reduce<D, RPT>(cluster, pl, st, part, blk_gmm, ps2, fin, i) &&
      i < m) {
    const int r = i - pl.row0;
#pragma unroll
    for (int dd = 0; dd < D; ++dd)
      gp_new[static_cast<size_t>(i) * D + dd] =
          (fin.acc[dd] / fin.l - (xn[r * D + dd] - c0[dd])) * (2.0f * pinv2);
  }
  cluster.sync();  // the other blocks have read this block's sums
}

template <int D>
int launch_step(const float* x, const float* score, const float* centers,
                const float* scal, float* x_new, float* gp_new, int m,
                cudaStream_t stream) {
  const Geometry g = geometry<D>(
      m, m, 2, (kWarps * merge_width<D>() + 2 * D + (D + 2) + D));
  if (g.rpt == 2)
    return launch(mpf_stream_kernel<D, 2>, g, stream, x, score, centers,
                  scal, x_new, gp_new, m, g.width, g.qe, g.nbuf);
  return launch(mpf_stream_kernel<D, 1>, g, stream, x, score, centers, scal,
                x_new, gp_new, m, g.width, g.qe, g.nbuf);
}

}  // namespace

// x, score, x_new, gp_new [m, d]; centers [m, d] (the prior is centered on
// the particles); scal [3] = (bw, pbw, lr). Device pointers, float32,
// contiguous; 1 <= d <= 8.
extern "C" int dust_mpf_stream_step(const float* x, const float* score,
                                    const float* centers, const float* scal,
                                    float* x_new, float* gp_new, int m,
                                    int d, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (m < 1 ? 0 : d) {
    case 1: return launch_step<1>(x, score, centers, scal, x_new, gp_new, m, s);
    case 2: return launch_step<2>(x, score, centers, scal, x_new, gp_new, m, s);
    case 3: return launch_step<3>(x, score, centers, scal, x_new, gp_new, m, s);
    case 4: return launch_step<4>(x, score, centers, scal, x_new, gp_new, m, s);
    case 5: return launch_step<5>(x, score, centers, scal, x_new, gp_new, m, s);
    case 6: return launch_step<6>(x, score, centers, scal, x_new, gp_new, m, s);
    case 7: return launch_step<7>(x, score, centers, scal, x_new, gp_new, m, s);
    case 8: return launch_step<8>(x, score, centers, scal, x_new, gp_new, m, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
