// Device code of the general paths (8 < d <= 128) of the streamed SVGD
// direction (K11, svgd_phi.cu) and of the GMM prior score (K12,
// gmm_score.cu); at d <= 8 both, and the fused SVGD step (K13), walk
// stream_split.cuh's split.
//
// One thread owns one particle row i and walks every column j (a particle
// or a prior center) itself, so no [m, m] matrix is ever stored; a block
// of kRowsWide rows stages column tiles of kTileCols columns through
// shared memory, read by all of its threads as broadcasts, and keeps each
// row's d-vectors in a [kVecs][d][rows] slice of shared memory. Distances
// are explicit per-dimension differences, exact at any offset. The
// products run against columns shifted by the first particle (or center),
// so their sums stay at spread scale.
//
// Each tile's terms are summed apart and then added to the row's running
// sums, so a sum over m columns carries ~(T + m / T) roundings, not ~m.

#pragma once

#include <cuda_runtime.h>

namespace dust_stream {

constexpr int kRowsWide = 64;    // rows per block, one thread each
constexpr int kTileCols = 32;    // columns per staged tile
constexpr int kMaxWideD = 128;   // the shared-memory limit on d
constexpr int kVecs = 5;         // d-vectors per row (RowVecs)

// floats of dynamic shared memory: three [T, d] tiles, two shift vectors
// and the rows' d-vectors
inline size_t smem_floats(int d) {
  return 3 * static_cast<size_t>(kTileCols) * d + 2 * d +
         kVecs * static_cast<size_t>(kRowsWide) * d;
}

// The d-vectors of this thread's row: 0 the row's coordinates, 1 and 2
// running sums, 3 and 4 the current tile's sums.
struct RowVecs {
  float* sm;   // [kVecs][d][rows]
  int d, rows, tid;

  __device__ __forceinline__ float& at(int k, int dd) {
    return sm[(k * d + dd) * rows + tid];
  }
};

// Shared-memory layout of one block.
struct Tiles {
  float* col;      // [T, d] the columns' coordinates
  float* colc;     // [T, d] the columns minus the shift
  float* aux;      // [T, d] the scores (SVGD)
  float* shift_a;  // [d] the SVGD shift: the first particle
  float* shift_b;  // [d] the GMM shift: the first center
  float* rowvecs;  // [kVecs][d][rows]
};

__device__ __forceinline__ Tiles carve(float* sh, int d) {
  Tiles t;
  t.col = sh;
  t.colc = t.col + kTileCols * d;
  t.aux = t.colc + kTileCols * d;
  t.shift_a = t.aux + kTileCols * d;
  t.shift_b = t.shift_a + d;
  t.rowvecs = t.shift_b + d;
  return t;
}

__device__ __forceinline__ float sq_dist(RowVecs& v, const float* col,
                                         int d) {
  float d2 = 0.0f;
  for (int dd = 0; dd < d; ++dd) {
    const float df = v.at(0, dd) - col[dd];
    d2 = d2 + df * df;
  }
  return d2;
}

// The SVGD sums of row v.at(0, .) over all m particles (per tile in
// v.at(3, .), v.at(4, .)): v.at(1, .) += K_ij score_j, v.at(2, .) +=
// K_ij (x_j - c), rows += K_ij, with K_ij = exp(-|x_i - x_j|^2 inv2) and
// c = t.shift_a. Every thread of the block calls it (it stages tiles
// between barriers).
__device__ inline void svgd_sums(const float* __restrict__ x,
                                 const float* __restrict__ score, int m,
                                 int d, float inv2, const Tiles& t,
                                 RowVecs& v, float& rows) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  for (int j0 = 0; j0 < m; j0 += kTileCols) {
    const int n = min(kTileCols, m - j0);
    float rows_t = 0.0f;
    for (int dd = 0; dd < d; ++dd) {
      v.at(3, dd) = 0.0f;
      v.at(4, dd) = 0.0f;
    }
    for (int e = tid; e < n * d; e += nt) {
      const float xv = x[static_cast<size_t>(j0) * d + e];
      t.col[e] = xv;
      t.colc[e] = xv - t.shift_a[e % d];
      t.aux[e] = score[static_cast<size_t>(j0) * d + e];
    }
    __syncthreads();
    for (int jj = 0; jj < n; ++jj) {
      const float k = expf(-sq_dist(v, t.col + jj * d, d) * inv2);
      rows_t = rows_t + k;
      const float* sc = t.aux + jj * d;
      const float* xc = t.colc + jj * d;
      for (int dd = 0; dd < d; ++dd) {
        v.at(3, dd) = v.at(3, dd) + k * sc[dd];
        v.at(4, dd) = v.at(4, dd) + k * xc[dd];
      }
    }
    rows = rows + rows_t;
    for (int dd = 0; dd < d; ++dd) {
      v.at(1, dd) = v.at(1, dd) + v.at(3, dd);
      v.at(2, dd) = v.at(2, dd) + v.at(4, dd);
    }
    __syncthreads();
  }
}

// The GMM prior-score sums of row v.at(0, .) over the kc centers, as an
// online softmax: logit_k = -|x_i - c_k|^2 inv2, running max mx,
// normalizer l += p and v.at(1, .) += p (c_k - c0) (per tile in v.at(3, .))
// with p = exp(logit_k - mx), all rescaled when the max grows;
// c0 = t.shift_b. Every thread of the block calls it.
__device__ inline void gmm_sums(const float* __restrict__ centers, int kc,
                                int d, float inv2, const Tiles& t,
                                RowVecs& v, float& mx, float& l) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  for (int j0 = 0; j0 < kc; j0 += kTileCols) {
    const int n = min(kTileCols, kc - j0);
    float l_t = 0.0f;
    for (int dd = 0; dd < d; ++dd) v.at(3, dd) = 0.0f;
    for (int e = tid; e < n * d; e += nt) {
      const float cv = centers[static_cast<size_t>(j0) * d + e];
      t.col[e] = cv;
      t.colc[e] = cv - t.shift_b[e % d];
    }
    __syncthreads();
    for (int jj = 0; jj < n; ++jj) {
      const float lg = -sq_dist(v, t.col + jj * d, d) * inv2;
      if (lg > mx) {
        const float s = expf(mx - lg);
        l = l * s;
        l_t = l_t * s;
        for (int dd = 0; dd < d; ++dd) {
          v.at(1, dd) = v.at(1, dd) * s;
          v.at(3, dd) = v.at(3, dd) * s;
        }
        mx = lg;
      }
      const float p = expf(lg - mx);
      l_t = l_t + p;
      const float* cc = t.colc + jj * d;
      for (int dd = 0; dd < d; ++dd)
        v.at(3, dd) = v.at(3, dd) + p * cc[dd];
    }
    l = l + l_t;
    for (int dd = 0; dd < d; ++dd) v.at(1, dd) = v.at(1, dd) + v.at(3, dd);
    __syncthreads();
  }
}

// Sets up this thread's row vectors and the block's shifts: loads row i of
// rows_src (zeros past m), zeroes accumulator 1 and 2, copies the first row
// of shift_a_src / shift_b_src (either may be null).
__device__ __forceinline__ RowVecs begin_rows(
    const float* __restrict__ rows_src, int m, int d, const Tiles& t,
    const float* shift_a_src, const float* shift_b_src) {
  const int tid = threadIdx.x;
  const int i = blockIdx.x * blockDim.x + tid;
  RowVecs v{t.rowvecs, d, static_cast<int>(blockDim.x), tid};
  for (int dd = 0; dd < d; ++dd) {
    v.at(0, dd) = i < m ? rows_src[static_cast<size_t>(i) * d + dd] : 0.0f;
    v.at(1, dd) = 0.0f;
    v.at(2, dd) = 0.0f;
  }
  for (int e = tid; e < d; e += blockDim.x) {
    if (shift_a_src != nullptr) t.shift_a[e] = shift_a_src[e];
    if (shift_b_src != nullptr) t.shift_b[e] = shift_b_src[e];
  }
  __syncthreads();
  return v;
}

// Grid, block and shared memory of a general-path kernel over m rows;
// raises the dynamic shared-memory limit where it needs more than 48 KB.
template <typename Kernel>
int configure(Kernel kernel, int m, int d, dim3* grid, dim3* block,
              size_t* bytes) {
  *bytes = smem_floats(d) * sizeof(float);
  *block = dim3(kRowsWide);
  *grid = dim3((m + kRowsWide - 1) / kRowsWide);
  if (*bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(*bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace dust_stream
