// Device code of the streamed SVGD direction (K11, svgd_phi.cu) and of the
// GMM prior score's general path (K12 at 8 < d <= 128, gmm_score.cu); K12
// at d <= 8 and the fused SVGD step (K13) walk stream_split.cuh's split.
//
// One thread owns one particle row i and walks every column j (a particle
// or a prior center) itself, so no [m, m] matrix is ever stored; a block
// stages column tiles of its inputs through shared memory, read by all of
// its threads as broadcasts. Distances are explicit per-dimension
// differences, exact at any offset. The products run against columns
// shifted by the first particle (or center): the same shift-invariant
// algebra as the TPU kernels' centered operands, so their bf16 rounding is
// of spread-scale values.
//
// Each tile's terms are summed apart and then added to the row's running
// sums, so a sum over m columns carries ~(T + m / T) roundings, not ~m.
//
// D > 0 (d <= 8): each row's vectors live in registers, tiles of 128
// columns. D == 0 (any d up to kMaxWideD): the vectors live in a
// [5][d][rows] slice of shared memory, tiles of 32 columns.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace dust_stream {

constexpr int kRows = 128;       // rows per block (one thread each), D > 0
constexpr int kRowsWide = 64;    // rows per block, D == 0
constexpr int kMaxWideD = 128;   // the general path's shared-memory limit
constexpr int kVecs = 5;         // d-vectors per row (RowVecs)

template <int D>
__host__ __device__ constexpr int tile_cols() {
  return D > 0 ? 128 : 32;
}

template <int D>
__host__ __device__ constexpr int block_rows() {
  return D > 0 ? kRows : kRowsWide;
}

// floats of dynamic shared memory: three [T, d] tiles, two shift vectors,
// and on the general path the rows' d-vectors
template <int D>
inline size_t smem_floats(int d) {
  return 3 * static_cast<size_t>(tile_cols<D>()) * d + 2 * d +
         (D > 0 ? 0 : kVecs * static_cast<size_t>(block_rows<D>()) * d);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The d-vectors of this thread's row: 0 the row's coordinates, 1 and 2
// running sums, 3 and 4 the current tile's sums.
template <int D>
struct RowVecs {
  float reg[kVecs * (D > 0 ? D : 1)];
  float* sm;   // D == 0: [kVecs][d][rows]
  int d, rows, tid;

  __device__ __forceinline__ float& at(int k, int dd) {
    if constexpr (D > 0) {
      return reg[k * D + dd];
    } else {
      return sm[(k * d + dd) * rows + tid];
    }
  }
};

// Shared-memory layout of one block.
struct Tiles {
  float* col;      // [T, d] the columns' coordinates
  float* colc;     // [T, d] the columns minus the shift (bf16 when asked)
  float* aux;      // [T, d] the scores (SVGD)
  float* shift_a;  // [d] the SVGD shift: the first particle
  float* shift_b;  // [d] the GMM shift: the first center
  float* rowvecs;  // D == 0: [kVecs][d][rows]
};

template <int D>
__device__ __forceinline__ Tiles carve(float* sh, int d) {
  constexpr int T = tile_cols<D>();
  Tiles t;
  t.col = sh;
  t.colc = t.col + T * d;
  t.aux = t.colc + T * d;
  t.shift_a = t.aux + T * d;
  t.shift_b = t.shift_a + d;
  t.rowvecs = t.shift_b + d;
  return t;
}

template <int D>
__device__ __forceinline__ float sq_dist(RowVecs<D>& v, const float* col,
                                         int d) {
  float d2 = 0.0f;
#pragma unroll
  for (int dd = 0; dd < (D > 0 ? D : d); ++dd) {
    const float df = v.at(0, dd) - col[dd];
    d2 = d2 + df * df;
  }
  return d2;
}

// The SVGD sums of row v.at(0, .) over all m particles (per tile in
// v.at(3, .), v.at(4, .)): v.at(1, .) += K_ij score_j, v.at(2, .) +=
// K_ij (x_j - c), rows += K_ij, with
// K_ij = exp(-|x_i - x_j|^2 inv2) and c = t.shift_a. bf16 rounds K, the
// scores and x_j - c before the products (f32 sums). Every thread of the
// block calls it (it stages tiles between barriers).
template <int D>
__device__ void svgd_sums(const float* __restrict__ x,
                          const float* __restrict__ score, int m, int d,
                          float inv2, bool bf16, const Tiles& t,
                          RowVecs<D>& v, float& rows) {
  constexpr int T = tile_cols<D>();
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  for (int j0 = 0; j0 < m; j0 += T) {
    const int n = min(T, m - j0);
    float rows_t = 0.0f;
#pragma unroll
    for (int dd = 0; dd < (D > 0 ? D : d); ++dd) {
      v.at(3, dd) = 0.0f;
      v.at(4, dd) = 0.0f;
    }
    for (int e = tid; e < n * d; e += nt) {
      const float xv = x[static_cast<size_t>(j0) * d + e];
      float xc = xv - t.shift_a[e % d];
      float s = score[static_cast<size_t>(j0) * d + e];
      if (bf16) {
        xc = bf16_round(xc);
        s = bf16_round(s);
      }
      t.col[e] = xv;
      t.colc[e] = xc;
      t.aux[e] = s;
    }
    __syncthreads();
    for (int jj = 0; jj < n; ++jj) {
      const float* col = t.col + jj * d;
      float k = expf(-sq_dist<D>(v, col, d) * inv2);
      if (bf16) k = bf16_round(k);
      rows_t = rows_t + k;
      const float* sc = t.aux + jj * d;
      const float* xc = t.colc + jj * d;
#pragma unroll
      for (int dd = 0; dd < (D > 0 ? D : d); ++dd) {
        v.at(3, dd) = v.at(3, dd) + k * sc[dd];
        v.at(4, dd) = v.at(4, dd) + k * xc[dd];
      }
    }
    rows = rows + rows_t;
#pragma unroll
    for (int dd = 0; dd < (D > 0 ? D : d); ++dd) {
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
// c0 = t.shift_b. bf16 rounds p and
// c_k - c0 before the products (f32 sums). Every thread of the block calls
// it.
template <int D>
__device__ void gmm_sums(const float* __restrict__ centers, int kc, int d,
                         float inv2, bool bf16, const Tiles& t,
                         RowVecs<D>& v, float& mx, float& l) {
  constexpr int T = tile_cols<D>();
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  for (int j0 = 0; j0 < kc; j0 += T) {
    const int n = min(T, kc - j0);
    float l_t = 0.0f;
#pragma unroll
    for (int dd = 0; dd < (D > 0 ? D : d); ++dd) v.at(3, dd) = 0.0f;
    for (int e = tid; e < n * d; e += nt) {
      const float cv = centers[static_cast<size_t>(j0) * d + e];
      const float cc = cv - t.shift_b[e % d];
      t.col[e] = cv;
      t.colc[e] = bf16 ? bf16_round(cc) : cc;
    }
    __syncthreads();
    for (int jj = 0; jj < n; ++jj) {
      const float lg = -sq_dist<D>(v, t.col + jj * d, d) * inv2;
      if (lg > mx) {
        const float s = expf(mx - lg);
        l = l * s;
        l_t = l_t * s;
#pragma unroll
        for (int dd = 0; dd < (D > 0 ? D : d); ++dd) {
          v.at(1, dd) = v.at(1, dd) * s;
          v.at(3, dd) = v.at(3, dd) * s;
        }
        mx = lg;
      }
      float p = expf(lg - mx);
      if (bf16) p = bf16_round(p);
      l_t = l_t + p;
      const float* cc = t.colc + jj * d;
#pragma unroll
      for (int dd = 0; dd < (D > 0 ? D : d); ++dd)
        v.at(3, dd) = v.at(3, dd) + p * cc[dd];
    }
    l = l + l_t;
#pragma unroll
    for (int dd = 0; dd < (D > 0 ? D : d); ++dd)
      v.at(1, dd) = v.at(1, dd) + v.at(3, dd);
    __syncthreads();
  }
}

// Sets up this thread's row vectors and the block's shifts: loads row i of
// rows_src (zeros past m), zeroes accumulator 1 and 2, copies the first row
// of shift_a_src / shift_b_src (either may be null).
template <int D>
__device__ __forceinline__ RowVecs<D> begin_rows(
    const float* __restrict__ rows_src, int m, int d, const Tiles& t,
    const float* shift_a_src, const float* shift_b_src) {
  const int tid = threadIdx.x;
  const int i = blockIdx.x * blockDim.x + tid;
  RowVecs<D> v;
  v.sm = t.rowvecs;
  v.d = d;
  v.rows = blockDim.x;
  v.tid = tid;
#pragma unroll
  for (int dd = 0; dd < (D > 0 ? D : d); ++dd) {
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

// Launches kernel<D> for d in 1..8, kernel<0> for 8 < d <= kMaxWideD, with
// ceil(m / rows) blocks and the shared memory its tiles need; returns the
// launch's CUDA error code.
template <template <int> class Launch, typename... Args>
int launch_for_d(int m, int d, cudaStream_t stream, Args... args) {
  switch (d) {
    case 1: return Launch<1>::run(m, d, stream, args...);
    case 2: return Launch<2>::run(m, d, stream, args...);
    case 3: return Launch<3>::run(m, d, stream, args...);
    case 4: return Launch<4>::run(m, d, stream, args...);
    case 5: return Launch<5>::run(m, d, stream, args...);
    case 6: return Launch<6>::run(m, d, stream, args...);
    case 7: return Launch<7>::run(m, d, stream, args...);
    case 8: return Launch<8>::run(m, d, stream, args...);
    default:
      if (d < 1 || d > kMaxWideD)
        return static_cast<int>(cudaErrorInvalidValue);
      return Launch<0>::run(m, d, stream, args...);
  }
}

// Grid, block and shared memory of kernel<D> over m rows; raises the
// dynamic shared-memory limit where the general path needs more than 48 KB.
template <int D, typename Kernel>
int configure(Kernel kernel, int m, int d, dim3* grid, dim3* block,
              size_t* bytes) {
  *bytes = smem_floats<D>(d) * sizeof(float);
  *block = dim3(block_rows<D>());
  *grid = dim3((m + block_rows<D>() - 1) / block_rows<D>());
  if (*bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(*bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace dust_stream
