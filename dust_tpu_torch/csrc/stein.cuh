// Block-level device code of the SVMPC solve shared by every whole-solve
// and whole-episode kernel of both tasks (K3/K4/K5 in pendulum_*.cu, K8/K9
// in particle_*.cu): NaN-propagating clamps and reductions, the DISCO and
// likelihood softmaxes, the Stein step with the forward pass, and the
// exact Silverman bandwidth. Every function here is called by all threads
// of a block of kThreads threads (they synchronise the block), unless its
// comment names one warp or some warps.
//
// The arithmetic follows the plain PyTorch versions (ops/solve.py,
// ops/episode.py) operation by operation: the library is built with
// --fmad=false, transcendentals at full precision, and every constant
// that Python folds in double precision arrives from the host already
// folded. Only the order of the sums over samples and particles differs.
// Clamps and max/min reductions propagate NaN as torch.clamp, amax and
// amin do.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace dust_solve {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxM = 8;       // policy particles
constexpr int kMaxParams = 8;  // dynamics-parameter draws

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
__device__ __forceinline__ float maxp(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float minp(float a, float b) {
  return (a < b || a != a) ? a : b;
}

// 2^v as one ex2.approx (the MPF loops' exps in base 2, log2 e folded into
// their scales): within ~1e-6 relative of expf at their arguments, at a
// fraction of its instructions.
constexpr float kLog2e = 1.4426950408889634f;
__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// a / b from y = 1 / b (correctly rounded): the product corrected by one
// fused multiply-add of its residual (Markstein). Equal to the IEEE
// division a / b in every one of 22 M float32 quotients checked in exact
// arithmetic (divisors 1-1024 and random), in three instructions where the
// division takes a checked routine; worth it where one reciprocal serves
// several quotients or the divisor is fixed.
__device__ __forceinline__ float div_rn(float a, float b, float y) {
  const float q = __fmul_rn(a, y);
  return __fmaf_rn(__fmaf_rn(-q, b, a), y, q);
}

// xor-butterfly reductions: every lane ends with the same bits
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v = v + __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = maxp(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = minp(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The mask of the aligned group of `lanes` lanes (a power of two <= 32) of
// this thread's warp.
__device__ __forceinline__ unsigned lane_group_mask(int lanes) {
  const unsigned ones = lanes == 32 ? 0xffffffffu : (1u << lanes) - 1u;
  return ones << ((threadIdx.x & 31) & ~(lanes - 1));
}

// The sum and max of v over an aligned group of L lanes, as a xor
// butterfly from the nearest lane out: every lane ends with the same bits,
// for L = 4 (p0 + p1) + (p2 + p3) (ops/particle_mpf.py:lane_sum repeats
// the order).
template <int L>
__device__ __forceinline__ float lane_group_sum(float v, unsigned mask) {
#pragma unroll
  for (int o = 1; o < L; o <<= 1) v = v + __shfl_xor_sync(mask, v, o);
  return v;
}
template <int L>
__device__ __forceinline__ float lane_group_max(float v, unsigned mask) {
#pragma unroll
  for (int o = 1; o < L; o <<= 1)
    v = maxp(v, __shfl_xor_sync(mask, v, o));
  return v;
}
// The max of v over the group with fmaxf, NaN-ignoring as a serial fmaxf
// walk: the MPF loops' prior-score max, where a NaN term makes the row's
// weight sum NaN all the same (the max is exact, so the order does not
// matter).
template <int L>
__device__ __forceinline__ float lane_group_fmax(float v, unsigned mask) {
#pragma unroll
  for (int o = 1; o < L; o <<= 1)
    v = fmaxf(v, __shfl_xor_sync(mask, v, o));
  return v;
}

// Block min of v[0..n) into *out (exact; order-free). red: >= kWarps.
__device__ inline void block_min(const float* v, int n, float* red,
                                 float* out) {
  float mn = INFINITY;
  for (int e = threadIdx.x; e < n; e += blockDim.x) mn = minp(mn, v[e]);
  mn = warp_min(mn);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = mn;
  __syncthreads();
  if (threadIdx.x == 0) {
    float r = red[0];
    for (int w = 1; w < kWarps; ++w) r = minp(r, red[w]);
    *out = r;
  }
  __syncthreads();
}

// The param-averaged cost of every (particle, sample) pair, mcost[pair]
// = (dcost[pair] + dcost[n + pair] + ...) / n_params with the draws added
// in draw order (ops/solve.py:rollout_mcost, particle_rollout_mcost);
// dcost [n_params, n] the draws' trajectory costs. The block's threads
// take the pairs in turn.
__device__ inline void sum_draws(const float* dcost, int n_params, int n,
                                 float* mcost) {
  const float inv_np = static_cast<float>(1.0 / n_params);
  for (int pair = threadIdx.x; pair < n; pair += blockDim.x) {
    float mc = dcost[pair];
    for (int p = 1; p < n_params; ++p) mc = mc + dcost[p * n + pair];
    mcost[pair] = mc * inv_np;
  }
}

struct DiscoConsts {
  float inv_temp, alpha, log_n_act, inv_n_act;
  int exp_util;
};

// The likelihood softmax wl and log-likelihood log_l of one particle row
// (ops/solve.py:disco_weights), from the row's costs mc [n_act]: they need
// no min over the rows. One warp calls it (lanes take the samples i =
// lane, lane + 32, ...); the divisions go through one reciprocal (div_rn).
__device__ inline void lik_row(const float* mc, int n_act,
                               const DiscoConsts& k, float* wl,
                               float* log_l) {
  const int lane = threadIdx.x & 31;
  float wmax = -INFINITY;
  for (int i = lane; i < n_act; i += 32) {
    const float w = -mc[i] * k.alpha;
    wl[i] = w;
    wmax = maxp(wmax, w);
  }
  wmax = warp_max(wmax);
  float sw = 0.0f, sc = 0.0f;
  for (int i = lane; i < n_act; i += 32) {
    const float w = expf(wl[i] - wmax);
    wl[i] = w;
    sw = sw + w;
    sc = sc + mc[i];
  }
  sw = warp_sum(sw);
  sc = warp_sum(sc);
  const float isw = 1.0f / sw;
  for (int i = lane; i < n_act; i += 32) wl[i] = div_rn(wl[i], sw, isw);
  if (lane == 0)
    *log_l = k.exp_util ? (wmax + logf(sw)) - k.log_n_act
                        : (-k.alpha) * sc * k.inv_n_act;
}

// The DISCO softmax weights om and eta of one particle row against the
// global min beta, as lik_row.
__device__ inline void omega_row(const float* mc, int n_act, float beta,
                                 const DiscoConsts& k, float* om,
                                 float* eta) {
  const int lane = threadIdx.x & 31;
  float rmax = -INFINITY;
  for (int i = lane; i < n_act; i += 32) {
    const float lc = -(mc[i] - beta) * k.inv_temp;
    om[i] = lc;
    rmax = maxp(rmax, lc);
  }
  rmax = warp_max(rmax);
  float se = 0.0f;
  for (int i = lane; i < n_act; i += 32) {
    const float e = expf(om[i] - rmax);
    om[i] = e;
    se = se + e;
  }
  se = warp_sum(se);
  const float ise = 1.0f / se;
  for (int i = lane; i < n_act; i += 32) om[i] = div_rn(om[i], se, ise);
  if (lane == 0) *eta = rmax + logf(se);
}

// Both softmaxes of one row. One warp calls it.
__device__ inline void disco_row(const float* mc, int n_act, float beta,
                                 const DiscoConsts& k, float* om, float* wl,
                                 float* eta, float* log_l) {
  lik_row(mc, n_act, k, wl, log_l);
  omega_row(mc, n_act, beta, k, om, eta);
}

// DISCO softmax weights omega and eta per particle, the likelihood's
// per-particle softmax w_lik and log-likelihood log_l
// (ops/solve.py:disco_weights). One warp per particle row; mcost, omega,
// w_lik [m * n_act]; eta, log_l [m]; red: >= kWarps + 1 scratch.
__device__ inline void disco_weights(const float* mcost, int m, int n_act,
                              const DiscoConsts& k, float* omega,
                              float* w_lik, float* eta, float* log_l,
                              float* red) {
  block_min(mcost, m * n_act, red, red + kWarps);
  const float beta = red[kWarps];
  for (int q = threadIdx.x >> 5; q < m; q += kWarps)
    disco_row(mcost + q * n_act, n_act, beta, k, omega + q * n_act,
              w_lik + q * n_act, eta + q, log_l + q);
  __syncthreads();
}

// Scratch of the Stein step (shared memory).
struct SteinSmem {
  float* lp;        // [m * m]
  float* r;         // [m * m]
  float* kmat;      // [m * m]
  float* rowsum;    // [m]
  float* log_w;     // [m]
  float* weights;   // [m]
  int* i_star;      // [1]
};

// The half of the Stein step that needs only the inputs
// (ops/solve.py:stein_forward): for every particle pair (q, c) the prior
// logit lp and the RBF kernel kmat, then per row the responsibilities r
// and the kernel's row sum. A warp per row q (rows q = w, w + n_warps, ...
// of warps w < n_warps, counted from warp `first`), lane c on the pair
// (q, c) (m <= 32). theta/locs [m * hz]; lm[c * lm_stride] the mixture
// log-weights.
__device__ inline void stein_prior(const float* theta, const float* locs,
                                   const float* lm, int lm_stride, int m,
                                   int hz, float bw, float inv_ps2,
                                   const SteinSmem& s, int first,
                                   int n_warps) {
  const int lane = threadIdx.x & 31;
  const float inv_2bw2 = 0.5f * (1.0f / (bw * bw));
  const float nh = -0.5f * inv_ps2;
  for (int q = (threadIdx.x >> 5) - first; q < m; q += n_warps) {
    if (lane < m) {
      const int c = lane;
      float sp = 0.0f, sk = 0.0f;
      for (int t = 0; t < hz; ++t) {
        const float d = theta[q * hz + t] - locs[c * hz + t];
        const float dk = theta[q * hz + t] - theta[c * hz + t];
        sp = sp + d * d;
        sk = sk + dk * dk;
      }
      s.lp[q * m + c] = nh * sp + lm[c * lm_stride];
      s.kmat[q * m + c] = expf(-inv_2bw2 * sk);
    }
    __syncwarp();
    if (lane == 0) {
      float rmax = -INFINITY;
      for (int c = 0; c < m; ++c) rmax = maxp(rmax, s.lp[q * m + c]);
      float se = 0.0f, rs = 0.0f;
      for (int c = 0; c < m; ++c) {
        const float e = expf(s.lp[q * m + c] - rmax);
        s.r[q * m + c] = e;
        se = se + e;
        rs = rs + s.kmat[q * m + c];
      }
      for (int c = 0; c < m; ++c) s.r[q * m + c] = s.r[q * m + c] / se;
      s.rowsum[q] = rs;
    }
    __syncwarp();
  }
}

// The rest of the Stein step, on s.r, s.kmat and s.rowsum from
// stein_prior: the score (score holds the likelihood gradient on entry and
// the score on return), the SGD step into theta_new, then the forward
// pass: the new particles' prior logits with their sums over the horizon
// taken kLanes lanes per pair (lane l adds t = l, l + kLanes, ..., then a
// butterfly; one lane is the serial sum), the posterior weights s.weights
// [m] and the first argmax *s.i_star (m when no row reaches the max).
// log_l [m]. Every thread of the block calls it.
template <int kLanes>
__device__ inline void stein_tail(const float* theta, const float* locs,
                                  float* score, const float* lm,
                                  int lm_stride, const float* log_l, int m,
                                  int hz, float bw, float lr, float inv_ps2,
                                  const SteinSmem& s, float* theta_new) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const float inv_bw2 = 1.0f / (bw * bw);
  const float nh = -0.5f * inv_ps2;
  const float inv_m = static_cast<float>(1.0 / m);
  for (int e = tid; e < m * hz; e += nt) {
    const int q = e / hz;
    const int t = e - q * hz;
    const float th = theta[e];
    float sc = score[e];
    for (int c = 0; c < m; ++c)
      sc = sc + s.r[q * m + c] * (locs[c * hz + t] - th) * inv_ps2;
    score[e] = sc;
  }
  __syncthreads();
  for (int e = tid; e < m * hz; e += nt) {
    const int q = e / hz;
    const int t = e - q * hz;
    float ks = 0.0f, kt = 0.0f;
    for (int c = 0; c < m; ++c) {
      const float kk = s.kmat[q * m + c];
      ks = ks + kk * score[c * hz + t];
      kt = kt + kk * theta[c * hz + t];
    }
    const float gk = -(kt - s.rowsum[q] * theta[e]) * inv_bw2;
    const float phi = (ks + gk) * inv_m;
    theta_new[e] = theta[e] + lr * phi;
  }
  __syncthreads();
  {
    const int sub = tid % kLanes;
    const unsigned mask = lane_group_mask(kLanes);
    for (int pr = tid / kLanes; pr < m * m; pr += nt / kLanes) {
      const int q = pr / m;
      const int c = pr - q * m;
      float sp = 0.0f;
      for (int t = sub; t < hz; t += kLanes) {
        const float d = theta_new[q * hz + t] - locs[c * hz + t];
        sp = sp + d * d;
      }
      sp = lane_group_sum<kLanes>(sp, mask);
      if (sub == 0) s.lp[pr] = nh * sp + lm[c * lm_stride];
    }
  }
  __syncthreads();
  if (tid < 32) {
    if (tid < m) {
      const int q = tid;
      float nmax = -INFINITY;
      for (int c = 0; c < m; ++c) nmax = maxp(nmax, s.lp[q * m + c]);
      float se = 0.0f;
      for (int c = 0; c < m; ++c) se = se + expf(s.lp[q * m + c] - nmax);
      s.log_w[q] = log_l[q] + (nmax + logf(se));
    }
    __syncwarp();
    if (tid == 0) {
      float wmax = -INFINITY;
      for (int q = 0; q < m; ++q) wmax = maxp(wmax, s.log_w[q]);
      float se = 0.0f;
      for (int q = 0; q < m; ++q) {
        const float w = expf(s.log_w[q] - wmax);
        s.weights[q] = w;
        se = se + w;
      }
      const float ise = 1.0f / se;
      int star = m;
      for (int q = m - 1; q >= 0; --q) {
        s.weights[q] = div_rn(s.weights[q], se, ise);
        if (s.log_w[q] >= wmax) star = q;
      }
      *s.i_star = star;
    }
  }
  __syncthreads();
}

// Stein direction + SGD step, then the forward pass
// (ops/solve.py:stein_forward), its sums serial: stein_prior on every
// warp, then stein_tail<1>. m <= 32. Every thread of the block calls it.
__device__ inline void stein_forward(const float* theta, const float* locs,
                                     float* score, const float* lm,
                                     int lm_stride, const float* log_l,
                                     int m, int hz, float bw, float lr,
                                     float inv_ps2, const SteinSmem& s,
                                     float* theta_new) {
  stein_prior(theta, locs, lm, lm_stride, m, hz, bw, inv_ps2, s, 0,
              blockDim.x >> 5);
  __syncthreads();
  stein_tail<1>(theta, locs, score, lm, lm_stride, log_l, m, hz, bw, lr,
                inv_ps2, s, theta_new);
}

// The constants of a Silverman bandwidth over n values
// (ops/episode.py:silverman_rows): the 1-based ranks of the four order
// statistics, the quartiles' interpolation weights and the scale
// (3n/4)^(-1/5), folded in double precision and rounded to float.
struct SilvermanN {
  int n, ks[4];
  float w25, f25, w75, f75, scale;
};

__device__ inline SilvermanN silverman_n(int n) {
  const double pos25 = 25.0 / 100.0 * (n - 1);
  const double pos75 = 75.0 / 100.0 * (n - 1);
  const int lo25 = static_cast<int>(floor(pos25));
  const int lo75 = static_cast<int>(floor(pos75));
  const double f25 = pos25 - lo25;
  const double f75 = pos75 - lo75;
  SilvermanN c;
  c.n = n;
  c.ks[0] = lo25 + 1;
  c.ks[1] = min(lo25 + 2, n);
  c.ks[2] = lo75 + 1;
  c.ks[3] = min(lo75 + 2, n);
  c.w25 = static_cast<float>(1.0 - f25);
  c.f25 = static_cast<float>(f25);
  c.w75 = static_cast<float>(1.0 - f75);
  c.f75 = static_cast<float>(f75);
  c.scale = static_cast<float>(pow(n * 3.0 / 4.0, -0.2));
  return c;
}

// The warps' partial sums of v and v^2 into red[0..kWarps) and
// red[kWarps..2 kWarps) (read after the caller's next barrier).
__device__ __forceinline__ void silverman_sums(const float* v, int n,
                                               float* red) {
  float a = 0.0f, b = 0.0f;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    a = a + v[e];
    b = b + v[e] * v[e];
  }
  a = warp_sum(a);
  b = warp_sum(b);
  if ((threadIdx.x & 31) == 0) {
    red[threadIdx.x >> 5] = a;
    red[kWarps + (threadIdx.x >> 5)] = b;
  }
}

// Thread 0's end of the bandwidth, from the sums in red and the order
// statistics os[0..4): the std, the IQR, sigma, the scaled bandwidth.
__device__ __forceinline__ float silverman_bw(const float* red,
                                              const float* os,
                                              const SilvermanN& c) {
  float s1 = red[0], s2 = red[kWarps];
  for (int w = 1; w < kWarps; ++w) {
    s1 = s1 + red[w];
    s2 = s2 + red[kWarps + w];
  }
  const float fn = static_cast<float>(c.n);
  const float mean = s1 / fn;
  const float var = (s2 - fn * mean * mean) / static_cast<float>(c.n - 1);
  const float std = sqrtf(maxp(var, 0.0f));
  const float q25 = os[0] * c.w25 + os[1] * c.f25;
  const float q75 = os[2] * c.w75 + os[3] * c.f75;
  const float iqr =
      (q75 - q25) * static_cast<float>(1.0 / 1.3489795003921634);
  const float sigma = iqr > 0.0f ? minp(std, iqr) : std;
  return maxp(sigma * c.scale, 1e-6f);
}

// KDEpy-convention Silverman bandwidth of v[0..n) from exact order
// statistics (ops/episode.py:silverman_rows): a rank count gives each
// value its sorted positions (#smaller + 1 .. #smaller-or-equal), exact
// under duplicates. red: >= 2 * kWarps + 5 scratch. Returns the bandwidth
// to every thread. (It keeps its own copy of silverman_n and silverman_bw:
// built from them, the pendulum episode kernel spilled and ran slower.)
__device__ inline float silverman(const float* v, int n, float* red) {
  float* os = red + 2 * kWarps;  // the 4 order statistics
  const double pos25 = 25.0 / 100.0 * (n - 1);
  const double pos75 = 75.0 / 100.0 * (n - 1);
  const int lo25 = static_cast<int>(floor(pos25));
  const int lo75 = static_cast<int>(floor(pos75));
  const double f25 = pos25 - lo25;
  const double f75 = pos75 - lo75;
  const int ks[4] = {lo25 + 1, min(lo25 + 2, n), lo75 + 1, min(lo75 + 2, n)};
  if (threadIdx.x < 4) os[threadIdx.x] = NAN;
  silverman_sums(v, n, red);
  __syncthreads();
  // the rank count: each thread counts for two values, e and e +
  // blockDim.x, in one pass over v (independent counters, unrolled, so the
  // shared-memory reads pipeline)
  for (int e = threadIdx.x; e < n; e += 2 * blockDim.x) {
    const int e2 = e + blockDim.x;
    const float v1 = v[e];
    const float v2 = e2 < n ? v[e2] : 0.0f;
    int lt1 = 0, le1 = 0, lt2 = 0, le2 = 0;
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      const float vj = v[j];
      lt1 += vj < v1;
      le1 += vj <= v1;
      lt2 += vj < v2;
      le2 += vj <= v2;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (lt1 < ks[k] && ks[k] <= le1) os[k] = v1;
      if (e2 < n && lt2 < ks[k] && ks[k] <= le2) os[k] = v2;
    }
  }
  __syncthreads();
  float bw = 0.0f;
  if (threadIdx.x == 0) {
    float s1 = red[0], s2 = red[kWarps];
    for (int w = 1; w < kWarps; ++w) {
      s1 = s1 + red[w];
      s2 = s2 + red[kWarps + w];
    }
    const float fn = static_cast<float>(n);
    const float mean = s1 / fn;
    const float var = (s2 - fn * mean * mean) / static_cast<float>(n - 1);
    const float std = sqrtf(maxp(var, 0.0f));
    const float q25 = os[0] * static_cast<float>(1.0 - f25) +
                      os[1] * static_cast<float>(f25);
    const float q75 = os[2] * static_cast<float>(1.0 - f75) +
                      os[3] * static_cast<float>(f75);
    const float iqr =
        (q75 - q25) * static_cast<float>(1.0 / 1.3489795003921634);
    const float sigma = iqr > 0.0f ? minp(std, iqr) : std;
    bw = maxp(sigma * static_cast<float>(pow(n * 3.0 / 4.0, -0.2)), 1e-6f);
    red[2 * kWarps + 4] = bw;
  }
  __syncthreads();
  bw = red[2 * kWarps + 4];
  __syncthreads();
  return bw;
}

// silverman() with the order statistics read from a sort: v[0..n) is
// copied into srt[0..N) (N a power of two >= n, padded with +inf) and
// bitonic-sorted by the block, log2(N) (log2(N) + 1) / 2 short stages in
// place of the O(n^2) rank count; c = silverman_n(n), made once per
// kernel. The same bandwidth as silverman() wherever v holds no NaN; with
// a NaN both return NaN (through the std).
__device__ inline float silverman_sorted(const float* v, const SilvermanN& c,
                                         int N, float* srt, float* red) {
  silverman_sums(v, c.n, red);
  for (int e = threadIdx.x; e < N; e += blockDim.x)
    srt[e] = e < c.n ? v[e] : INFINITY;
  __syncthreads();
  for (int k = 2; k <= N; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < N; i += blockDim.x) {
        const int l = i ^ j;
        if (l > i) {
          const float x = srt[i], y = srt[l];
          if ((i & k) == 0 ? x > y : x < y) {
            srt[i] = y;
            srt[l] = x;
          }
        }
      }
      __syncthreads();
    }
  }
  if (threadIdx.x == 0) {
    float* os = red + 2 * kWarps;
#pragma unroll
    for (int k = 0; k < 4; ++k) os[k] = srt[c.ks[k] - 1];
    red[2 * kWarps + 4] = silverman_bw(red, os, c);
  }
  __syncthreads();
  const float bw = red[2 * kWarps + 4];
  __syncthreads();
  return bw;
}

}  // namespace dust_solve
