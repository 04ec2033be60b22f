// Device code shared by the streamed SVGD direction (K11, svgd_phi.cu,
// d <= 8), the streamed GMM prior score (K12, gmm_score.cu, d <= 8) and the
// fused SVGD step (K13, mpf_stream.cu): a column walk split across warps
// and across a thread-block cluster.
//
// A row tile of 32 * RPT rows (RPT rows per lane, lane l owning rows
// l, l + 32, ...) is owned by a cluster of C blocks of kWarps warps. Every
// warp of every block holds all the tile's rows in registers and walks its
// own slice of the columns (ops/stream_split.py:column_split gives C and
// the slice width), so no [m, k] matrix is stored and the work is spread
// over 8 C warps per tile. A warp stages its slice into its own region of
// shared memory with cp.async, in chunks of at most chunk_cols<D>()
// columns, double-buffered past one chunk; only __syncwarp orders the
// staging and the walk.
//
// The partial states merge in a fixed order, first over the block's warps
// through shared memory, then over the cluster's blocks through
// distributed shared memory (map_shared_rank), so a call gives the same
// bits every time and no float atomics are needed.
//
// The tile size, the warps per block and the cluster limit come from
// ops/stream_split.py through nvcc macro definitions (ops/_build.py).

#pragma once

#include <math.h>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cp_async.cuh"

#if !defined(DUST_TILE_COLS) || !defined(DUST_SLICE_WARPS) || \
    !defined(DUST_MAX_CLUSTER) || !defined(DUST_MIN_SLICE)
#error "build with ops/_build.py, which defines the column-split constants"
#endif

namespace dust_split {

namespace cg = cooperative_groups;

constexpr int kTile = DUST_TILE_COLS;
constexpr int kWarps = DUST_SLICE_WARPS;
constexpr int kMaxCluster = DUST_MAX_CLUSTER;
constexpr int kMinSlice = DUST_MIN_SLICE;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunkFloats = 1024;  // floats of one staged array per chunk
constexpr float kLog2e = 1.4426950408889634f;

// columns per staged chunk: kChunkFloats / D, a multiple of kTile
template <int D>
__host__ __device__ constexpr int chunk_cols() {
  return (kChunkFloats / D) / kTile * kTile > kTile
             ? (kChunkFloats / D) / kTile * kTile
             : kTile;
}

// ops/stream_split.py:column_split
struct Split {
  int cluster, width;
};

inline Split column_split(int k) {
  int cluster = 1;
  while (cluster < kMaxCluster &&
         static_cast<long long>(cluster) * kWarps * kMinSlice < k)
    cluster *= 2;
  const int per = (k + cluster * kWarps - 1) / (cluster * kWarps);
  return {cluster, (per + kTile - 1) / kTile * kTile};
}

// Launch geometry and shared memory of one kernel over m rows and k
// columns: rows per lane, the cluster, the slice width, the staged chunk
// (qe columns, nbuf buffers) and the bytes of dynamic shared memory, given
// the arrays staged per chunk and the floats per row of the merge areas.
struct Geometry {
  int rpt, tiles, cluster, width, qe, nbuf;
  size_t bytes;
};

template <int D>
inline Geometry geometry(int m, int k, int arrays, int merge_floats) {
  Geometry g;
  const Split s = column_split(k);
  g.cluster = s.cluster;
  g.width = s.width;
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // two rows per lane where that still puts two blocks on every SM
  const int tiles2 = (m + 63) / 64;
  g.rpt = static_cast<long long>(tiles2) * g.cluster >= 2LL * sms ? 2 : 1;
  g.tiles = (m + 32 * g.rpt - 1) / (32 * g.rpt);
  g.qe = g.width < chunk_cols<D>() ? g.width : chunk_cols<D>();
  g.nbuf = g.width > g.qe ? 2 : 1;
  g.bytes = sizeof(float) *
            (static_cast<size_t>(kWarps) * g.nbuf * arrays * g.qe * D +
             static_cast<size_t>(merge_floats) * 32 * g.rpt);
  return g;
}

// Launches kernel over g.tiles clusters of g.cluster blocks; returns the
// CUDA error code.
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), const Geometry& g, cudaStream_t stream,
           Args... args) {
  if (g.bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(g.bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.tiles * g.cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = g.bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

using dust_async::cp_async4;
using dust_async::cp_async_commit;
using dust_async::cp_async_wait;

// Where this thread's block sits: its tile's first row, its rank in the
// cluster, its warp's column slice [j0, j1) and its lane.
struct Place {
  int row0, rank, cluster, j0, j1, warp, lane;
};

template <int RPT>
__device__ __forceinline__ Place place(cg::cluster_group& cluster,
                                       int k, int width) {
  Place p;
  p.cluster = static_cast<int>(cluster.num_blocks());
  p.rank = static_cast<int>(cluster.block_rank());
  p.row0 = static_cast<int>(blockIdx.x) / p.cluster * 32 * RPT;
  p.warp = threadIdx.x >> 5;
  p.lane = threadIdx.x & 31;
  const long long s = static_cast<long long>(p.rank) * kWarps + p.warp;
  p.j0 = static_cast<int>(min(static_cast<long long>(k), s * width));
  p.j1 = static_cast<int>(min(static_cast<long long>(k), (s + 1) * width));
  return p;
}

// Streams the columns [j0, j1) of the NC arrays src ([*, D] floats each)
// through this warp's staging area wb: nbuf buffers of nb arrays of qe
// columns. Each lane copies whole columns (col = lane, lane + 32, ...) and
// prep(buf, col) transforms exactly the columns it copied once they land;
// body(buf, n) then walks the chunk's n columns with the whole warp.
template <int D, int NC, typename Prep, typename Body>
__device__ __forceinline__ void walk_slice(const float* const* src,
                                           int j0, int j1, float* wb, int nb,
                                           int qe, int lane, Prep prep,
                                           Body body) {
  if (j0 >= j1) return;
  const int stride = nb * qe * D;
  auto issue = [&](int c0, float* buf) {
    const int n = min(qe, j1 - c0);
#pragma unroll
    for (int a = 0; a < NC; ++a)
      for (int col = lane; col < n; col += 32)
#pragma unroll
        for (int dd = 0; dd < D; ++dd)
          cp_async4(buf + a * qe * D + col * D + dd,
                    src[a] + (static_cast<size_t>(c0) + col) * D + dd);
    cp_async_commit();
  };
  issue(j0, wb);
  int cur = 0;
  for (int c0 = j0; c0 < j1; c0 += qe) {
    float* buf = wb + cur * stride;
    const int n = min(qe, j1 - c0);
    if (c0 + qe < j1) {
      issue(c0 + qe, wb + (cur ^ 1) * stride);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    for (int col = lane; col < n; col += 32) prep(buf, col);
    __syncwarp();
    body(buf, n);
    __syncwarp();
    cur ^= 1;
  }
}

// The online-softmax state of one row over the columns walked so far, in
// squared distances: dmin the least |x_i - c_k|^2 (the largest logit), l
// the sum of p_k = exp((dmin - |x_i - c_k|^2) inv2), acc the sum of
// p_k cc_k (cc_k the shifted center). Empty: dmin = inf, l = 0.
template <int D>
struct Soft {
  float dmin, l, acc[D];
};

template <int D>
__device__ __forceinline__ void soft_clear(Soft<D>& s) {
  s.dmin = INFINITY;
  s.l = 0.0f;
#pragma unroll
  for (int dd = 0; dd < D; ++dd) s.acc[dd] = 0.0f;
}

// a <- a merged with b (b given as dmin, l, acc[D] floats); s2 = inv2 log2 e
template <int D>
__device__ __forceinline__ void soft_merge(Soft<D>& a, const float* b,
                                           float s2) {
  if (!(b[1] != 0.0f)) return;  // b empty
  if (!(a.l != 0.0f)) {
    a.dmin = b[0];
    a.l = b[1];
#pragma unroll
    for (int dd = 0; dd < D; ++dd) a.acc[dd] = b[2 + dd];
    return;
  }
  const float nm = fminf(a.dmin, b[0]);
  const float sa = ex2((nm - a.dmin) * s2);
  const float sb = ex2((nm - b[0]) * s2);
  a.l = __fmaf_rn(a.l, sa, b[1] * sb);
#pragma unroll
  for (int dd = 0; dd < D; ++dd)
    a.acc[dd] = __fmaf_rn(a.acc[dd], sa, b[2 + dd] * sb);
  a.dmin = nm;
}

template <int D>
__device__ __forceinline__ void soft_store(const Soft<D>& s, float* out) {
  out[0] = s.dmin;
  out[1] = s.l;
#pragma unroll
  for (int dd = 0; dd < D; ++dd) out[2 + dd] = s.acc[dd];
}

// Folds n staged centers into the rows' states: cc [n, D] the shifted
// centers (for the distances), pc [n, D] the products' operands (cc, or cc
// rounded to bf16), xr the rows shifted alike. Per tile of kTile columns:
// the squared distances in registers, the tile's least one, one rescale of
// the state, then the weights (rounded to bf16 when asked) and their sums.
template <int D, int RPT>
__device__ __forceinline__ void soft_walk(const float* cc, const float* pc,
                                          int n, const float (&xr)[RPT][D],
                                          float s2, bool bf16,
                                          Soft<D> (&st)[RPT]) {
  for (int t0 = 0; t0 < n; t0 += kTile) {
    float d2[RPT][kTile];
    float tmin[RPT];
#pragma unroll
    for (int q = 0; q < RPT; ++q) tmin[q] = INFINITY;
#pragma unroll
    for (int jj = 0; jj < kTile; ++jj) {
      const bool ok = t0 + jj < n;
      const float* c = cc + min(t0 + jj, n - 1) * D;
#pragma unroll
      for (int q = 0; q < RPT; ++q) {
        float acc = 0.0f;
#pragma unroll
        for (int dd = 0; dd < D; ++dd) {
          const float df = xr[q][dd] - c[dd];
          acc = __fmaf_rn(df, df, acc);
        }
        d2[q][jj] = ok ? acc : INFINITY;
        tmin[q] = fminf(tmin[q], d2[q][jj]);
      }
    }
    float off[RPT];
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      const float nm = fminf(st[q].dmin, tmin[q]);
      const float sc = ex2((nm - st[q].dmin) * s2);
      st[q].l = st[q].l * sc;
#pragma unroll
      for (int dd = 0; dd < D; ++dd) st[q].acc[dd] = st[q].acc[dd] * sc;
      st[q].dmin = nm;
      off[q] = nm * s2;
    }
#pragma unroll
    for (int jj = 0; jj < kTile; ++jj) {
      const float* c = pc + min(t0 + jj, n - 1) * D;
#pragma unroll
      for (int q = 0; q < RPT; ++q) {
        float p = ex2(__fmaf_rn(d2[q][jj], -s2, off[q]));
        if (bf16) p = bf16_round(p);
        st[q].l = st[q].l + p;
#pragma unroll
        for (int dd = 0; dd < D; ++dd)
          st[q].acc[dd] = __fmaf_rn(p, c[dd], st[q].acc[dd]);
      }
    }
  }
}

// The sums of the SVGD direction (K11, svgd_phi.cu; K13's first half,
// mpf_stream.cu) of the tile's rows over all m particles. Every warp walks
// its own slice of the particles and scores; per particle j, K_ij is one
// ex2 (s2 = inv2 log2 e) and the sums explicit fmas:
//   f32:  sum_j K_ij score_j and sum_j K_ij (x_i - x_j), the difference the
//         distance already formed (no shift);
//   bf16: K_ij, score_j and x_j - x_0 rounded to bf16 before the products:
//         sum_j K_ij score_j, sum_j K_ij (x_j - x_0) and sum_j K_ij.
// The warps' sums merge in warp order through `part` (kWarps x 32 RPT rows
// of pf >= kFloats floats), then the cluster's blocks' in rank order through
// `blk` (32 RPT x kFloats floats, read by the other blocks until the
// caller's closing cluster.sync()): thread r < 32 RPT of every block ends
// with row r's sums in acc. stage: this warp's staging area, nbuf buffers
// of kArrays arrays of qe columns.
template <int D, bool BF16>
struct PhiSums {
  static constexpr int kArrays = BF16 ? 3 : 2;  // x, score (, x - x_0)
  static constexpr int kFloats = BF16 ? 2 * D + 1 : 2 * D;
};

template <int D, int RPT, bool BF16>
__device__ __forceinline__ void phi_sums(
    cg::cluster_group& cluster, const Place& pl,
    const float* __restrict__ x, const float* __restrict__ score, int m,
    float s2, float* stage, int qe, float* part, int pf, float* blk,
    float (&acc)[PhiSums<D, BF16>::kFloats]) {
  constexpr int R = 32 * RPT;
  constexpr int F = PhiSums<D, BF16>::kFloats;
  float xr[RPT][D], ss[RPT][D], sx[RPT][D], rs[RPT];
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const int i = pl.row0 + q * 32 + pl.lane;
    rs[q] = 0.0f;
#pragma unroll
    for (int dd = 0; dd < D; ++dd) {
      xr[q][dd] = i < m ? x[static_cast<size_t>(i) * D + dd] : 0.0f;
      ss[q][dd] = 0.0f;
      sx[q][dd] = 0.0f;
    }
  }
  if constexpr (BF16) {
    float c0[D];
#pragma unroll
    for (int dd = 0; dd < D; ++dd) c0[dd] = x[dd];
    const float* src[3] = {x, score, x};
    walk_slice<D, 3>(
        src, pl.j0, pl.j1, stage, 3, qe, pl.lane,
        [&](float* buf, int col) {
#pragma unroll
          for (int dd = 0; dd < D; ++dd) {
            float* s = buf + qe * D + col * D + dd;
            float* c = buf + 2 * qe * D + col * D + dd;
            *s = bf16_round(*s);
            *c = bf16_round(*c - c0[dd]);
          }
        },
        [&](const float* buf, int n) {
          const float* sc = buf + qe * D;
          const float* xc = buf + 2 * qe * D;
#pragma unroll 4
          for (int j = 0; j < n; ++j) {
#pragma unroll
            for (int q = 0; q < RPT; ++q) {
              float d2 = 0.0f;
#pragma unroll
              for (int dd = 0; dd < D; ++dd) {
                const float df = xr[q][dd] - buf[j * D + dd];
                d2 = __fmaf_rn(df, df, d2);
              }
              const float k = bf16_round(ex2(d2 * -s2));
              rs[q] = rs[q] + k;
#pragma unroll
              for (int dd = 0; dd < D; ++dd) {
                ss[q][dd] = __fmaf_rn(k, sc[j * D + dd], ss[q][dd]);
                sx[q][dd] = __fmaf_rn(k, xc[j * D + dd], sx[q][dd]);
              }
            }
          }
        });
  } else {
    const float* src[2] = {x, score};
    walk_slice<D, 2>(
        src, pl.j0, pl.j1, stage, 2, qe, pl.lane, [](float*, int) {},
        [&](const float* buf, int n) {
          const float* sc = buf + qe * D;
#pragma unroll 4
          for (int j = 0; j < n; ++j) {
#pragma unroll
            for (int q = 0; q < RPT; ++q) {
              float df[D];
              float d2 = 0.0f;
#pragma unroll
              for (int dd = 0; dd < D; ++dd) {
                df[dd] = xr[q][dd] - buf[j * D + dd];
                d2 = __fmaf_rn(df[dd], df[dd], d2);
              }
              const float k = ex2(d2 * -s2);
#pragma unroll
              for (int dd = 0; dd < D; ++dd) {
                ss[q][dd] = __fmaf_rn(k, sc[j * D + dd], ss[q][dd]);
                sx[q][dd] = __fmaf_rn(k, df[dd], sx[q][dd]);
              }
            }
          }
        });
  }
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    float* p = part + (pl.warp * R + q * 32 + pl.lane) * pf;
#pragma unroll
    for (int dd = 0; dd < D; ++dd) {
      p[dd] = ss[q][dd];
      p[D + dd] = sx[q][dd];
    }
    if constexpr (BF16) p[2 * D] = rs[q];
  }
  __syncthreads();
  if (threadIdx.x < R) {
#pragma unroll
    for (int e = 0; e < F; ++e) acc[e] = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      const float* p = part + (w * R + threadIdx.x) * pf;
#pragma unroll
      for (int e = 0; e < F; ++e) acc[e] = acc[e] + p[e];
    }
#pragma unroll
    for (int e = 0; e < F; ++e) blk[threadIdx.x * F + e] = acc[e];
  }
  cluster.sync();
  if (threadIdx.x < R) {
#pragma unroll
    for (int e = 0; e < F; ++e) acc[e] = 0.0f;
    for (int b = 0; b < pl.cluster; ++b) {
      const float* p = cluster.map_shared_rank(blk, b) + threadIdx.x * F;
#pragma unroll
      for (int e = 0; e < F; ++e) acc[e] = acc[e] + p[e];
    }
  }
}

// Merges the rows' states over the block's warps (in warp order) and then
// over the cluster's blocks (in rank order) and returns, for the rows
// [row0 + rank * per, row0 + (rank + 1) * per) of the tile (per = 32 RPT /
// cluster) that thread t < per finishes, whether it has one; `part` is
// kWarps x 32 RPT x (D + 2) floats, `blk` 32 RPT x (D + 2) floats, which
// other blocks read until the caller's closing cluster.sync().
template <int D, int RPT>
__device__ __forceinline__ bool soft_reduce(
    cg::cluster_group& cluster, const Place& pl, Soft<D> (&st)[RPT],
    float* part, float* blk, float s2, Soft<D>& out, int& row) {
  constexpr int R = 32 * RPT;
  constexpr int F = D + 2;
#pragma unroll
  for (int q = 0; q < RPT; ++q)
    soft_store(st[q], part + (pl.warp * R + q * 32 + pl.lane) * F);
  __syncthreads();
  if (threadIdx.x < R) {
    Soft<D> s;
    soft_clear(s);
    for (int w = 0; w < kWarps; ++w)
      soft_merge(s, part + (w * R + threadIdx.x) * F, s2);
    soft_store(s, blk + threadIdx.x * F);
  }
  cluster.sync();
  const int per = R / pl.cluster;
  if (static_cast<int>(threadIdx.x) >= per) return false;
  const int r = pl.rank * per + threadIdx.x;
  soft_clear(out);
  for (int b = 0; b < pl.cluster; ++b)
    soft_merge(out, cluster.map_shared_rank(blk, b) + r * F, s2);
  row = pl.row0 + r;
  return true;
}

}  // namespace dust_split
