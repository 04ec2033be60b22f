// Device code of the general paths above d = 128 of the streamed SVGD
// direction (K11a, svgd_phi.cu) and of the GMM prior score (K12a,
// gmm_score.cu). At d <= 128 stream_tiles.cuh keeps each row's d-vectors
// in shared memory; above that they do not fit (five vectors of 64 rows
// at d = 128 already fill 214 KB of the 227 KB), so here the dimensions
// are walked in chunks of kChunk and nothing of size d stays on chip.
//
// A block owns kRows rows, two per warp, and walks the columns (particles
// or centers) in tiles of kCols, lane j of each warp on column j of the
// tile. Per tile:
//   1. the squared distances of the warp's two rows to the lane's column,
//      summed over dd = 0 .. d-1 in order (the plain version's order), in
//      registers, as the rows' and the columns' d-chunks pass through
//      shared memory;
//   2. the kernel values (K11) or the online-softmax weights against the
//      running max (K12), one per lane and row; the rows' scalars (row
//      sum, max, normalizer) reduced over the warp's lanes;
//   3. a second walk over the d-chunks: the chunk's column operands staged
//      once, each lane owns dims lane + 32 k of the chunk for the warp's
//      two rows and sums the tile's terms apart (the weights broadcast by
//      shuffle), then adds them to the rows' running sums, which stay in
//      the output rows in device memory: each thread reads and writes
//      only its own elements, so no barrier guards them.
// The columns are shifted by the first particle (or center) before the
// products, so the sums stay at spread scale, as in stream_tiles.cuh.

#pragma once

#include <cuda_runtime.h>

namespace dust_dchunk {

constexpr int kRows = 16;             // rows per block, two per warp
constexpr int kWarps = kRows / 2;
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 32;             // columns per tile, one per lane
constexpr int kChunk = 128;           // dims per staged chunk
constexpr int kPitch = kChunk + 1;    // padded: lane j reads column j
constexpr int kPer = kChunk / 32;     // dims of a chunk per lane
constexpr unsigned kFull = 0xffffffffu;

struct Smem {
  float col[kCols * kPitch];   // the tile's columns, one chunk
  float row[kRows * kPitch];   // the block's rows, one chunk
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = v + __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Squared distances of this warp's two rows (block rows 2 warp, 2 warp + 1
// of rows_src [m, d]) to column j0 + lane of cols [n_cols, d], summed over
// the dimensions in order; zeros stand in past m and n_cols. Every thread
// of the block calls it.
__device__ inline void distances(const float* __restrict__ rows_src, int m,
                                 const float* __restrict__ cols, int n_cols,
                                 int j0, int d, int row0, Smem& sm,
                                 float& d2a, float& d2b) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  d2a = 0.0f;
  d2b = 0.0f;
  for (int c0 = 0; c0 < d; c0 += kChunk) {
    const int nd = min(kChunk, d - c0);
    __syncthreads();  // the previous chunk has been read
    for (int jj = warp; jj < kCols; jj += kWarps) {
      const int j = j0 + jj;
      for (int dd = lane; dd < kChunk; dd += 32)
        sm.col[jj * kPitch + dd] =
            j < n_cols && dd < nd
                ? cols[static_cast<size_t>(j) * d + c0 + dd] : 0.0f;
    }
    for (int rr = warp; rr < kRows; rr += kWarps) {
      const int i = row0 + rr;
      for (int dd = lane; dd < kChunk; dd += 32)
        sm.row[rr * kPitch + dd] =
            i < m && dd < nd
                ? rows_src[static_cast<size_t>(i) * d + c0 + dd] : 0.0f;
    }
    __syncthreads();
    const float* cv = sm.col + lane * kPitch;
    const float* xa = sm.row + (2 * warp) * kPitch;
    const float* xb = xa + kPitch;
    for (int dd = 0; dd < nd; ++dd) {
      const float da = xa[dd] - cv[dd];
      d2a = d2a + da * da;
      const float db = xb[dd] - cv[dd];
      d2b = d2b + db * db;
    }
  }
}

// This tile's sums for the warp's two rows over the staged chunk in
// sm.col: ta[k] = sum_jj wa(jj) col[jj][lane + 32 k], in column order, with
// wa(jj) lane jj's weight; zero-staged columns add nothing.
__device__ __forceinline__ void tile_sums(const Smem& sm, float wa, float wb,
                                          float (&ta)[kPer],
                                          float (&tb)[kPer]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    ta[k] = 0.0f;
    tb[k] = 0.0f;
  }
  for (int jj = 0; jj < kCols; ++jj) {
    const float a = __shfl_sync(kFull, wa, jj);
    const float b = __shfl_sync(kFull, wb, jj);
    const float* c = sm.col + jj * kPitch + lane;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      ta[k] = ta[k] + a * c[32 * k];
      tb[k] = tb[k] + b * c[32 * k];
    }
  }
}

// Row i's running sums of chunk c0 (in out [m, d]): set to the tile's sums
// on the first tile, else rescaled by s and the tile's sums added.
__device__ __forceinline__ void add_tile(float* __restrict__ out, int i,
                                         int m, int d, int c0, int nd,
                                         float s, bool first,
                                         const float (&t)[kPer]) {
  if (i >= m) return;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int dd = lane + 32 * k;
    if (dd < nd) {
      float* p = out + static_cast<size_t>(i) * d + c0 + dd;
      *p = first ? t[k] : *p * s + t[k];
    }
  }
}

}  // namespace dust_dchunk
