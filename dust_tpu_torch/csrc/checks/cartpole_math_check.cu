// Checks of cartpole_math.cuh against the CUDA library on the card
// (chip_smoke.py phase 42), built on their own with the library's flags
// into a small shared library; not part of libdust_tpu_torch.
//
// dust_check_trig: fast_sincosf against sincosf (both outputs) and its
// cosine against cosf over every float with |x| < kTrigBound.
// dust_check_div: fast_div against `/` over n pseudo-random pairs, mode 0
// across div_ok's whole range, mode 1 over K14's: the numerator uniform in
// [-1024, 1024], the denominator in [1/32, 8].
// dust_check_eval: trig_ok, fast and library values of given x, and
// div_ok, fast and library quotients of given pairs (the edge cases).
// Each launches on `stream` and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "../cartpole_math.cuh"

namespace {

using namespace dust_cartpole;

constexpr int kFirst = 16;  // mismatches recorded in full

__global__ void trig_kernel(uint32_t n_pos, unsigned long long* counts,
                            uint32_t* first) {
  const uint64_t total = 2ull * n_pos;
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  for (uint64_t k = blockIdx.x * static_cast<uint64_t>(blockDim.x) +
                    threadIdx.x;
       k < total; k += stride) {
    const uint32_t bits = static_cast<uint32_t>(k % n_pos) |
                          (k >= n_pos ? 0x80000000u : 0u);
    const float x = __uint_as_float(bits);
    float s, c, fs, fc;
    sincosf(x, &s, &c);
    const float cc = cosf(x);
    fast_sincosf(x, fs, fc);
    const bool m0 = __float_as_uint(s) != __float_as_uint(fs);
    const bool m1 = __float_as_uint(c) != __float_as_uint(fc);
    const bool m2 = __float_as_uint(cc) != __float_as_uint(fc);
    const bool m3 = !trig_ok(x);
    if (m0 | m1 | m2 | m3) {
      if (m0) atomicAdd(&counts[0], 1ull);
      if (m1) atomicAdd(&counts[1], 1ull);
      if (m2) atomicAdd(&counts[2], 1ull);
      if (m3) atomicAdd(&counts[3], 1ull);
      const unsigned long long slot = atomicAdd(&counts[4], 1ull);
      if (slot < kFirst) {
        uint32_t* f = first + 6 * slot;
        f[0] = bits;
        f[1] = __float_as_uint(s);
        f[2] = __float_as_uint(fs);
        f[3] = __float_as_uint(c);
        f[4] = __float_as_uint(fc);
        f[5] = __float_as_uint(cc);
      }
    }
  }
}

__device__ __forceinline__ uint32_t mix(uint64_t k) {
  k ^= k >> 33;
  k *= 0xff51afd7ed558ccdull;
  k ^= k >> 33;
  k *= 0xc4ceb9fe1a85ec53ull;
  k ^= k >> 33;
  return static_cast<uint32_t>(k);
}

// a float of random sign and mantissa with its exponent uniform over
// [-60, 59]: every magnitude of [kDivMin, kDivMax)
__device__ __forceinline__ float any_in_range(uint64_t k) {
  const uint32_t h = mix(k), g = mix(k ^ 0x9e3779b97f4a7c15ull);
  const uint32_t e = 127u - 60u + g % 120u;
  return __uint_as_float((e << 23) | (h & 0x7fffffu) | (g & 0x80000000u));
}

// uniform in [lo, hi) from 24 random bits
__device__ __forceinline__ float uniform(uint64_t k, float lo, float hi) {
  const float u = static_cast<float>(mix(k) >> 8) * 0x1p-24f;
  return lo + (hi - lo) * u;
}

__global__ void div_kernel(int mode, uint64_t n,
                           unsigned long long* counts, uint32_t* first) {
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  for (uint64_t k = blockIdx.x * static_cast<uint64_t>(blockDim.x) +
                    threadIdx.x;
       k < n; k += stride) {
    float a, b;
    if (mode == 0) {
      a = any_in_range(2 * k);
      b = any_in_range(2 * k + 1);
    } else {
      a = uniform(2 * k, -1024.0f, 1024.0f);
      b = uniform(2 * k + 1, 0.03125f, 8.0f);
    }
    if (!div_ok(a, b)) {
      atomicAdd(&counts[1], 1ull);
      continue;
    }
    const float q = a / b;
    const float g = fast_div(a, b);
    if (__float_as_uint(q) != __float_as_uint(g)) {
      const unsigned long long slot = atomicAdd(&counts[0], 1ull);
      if (slot < kFirst) {
        uint32_t* f = first + 4 * slot;
        f[0] = __float_as_uint(a);
        f[1] = __float_as_uint(b);
        f[2] = __float_as_uint(q);
        f[3] = __float_as_uint(g);
      }
    }
  }
}

__global__ void eval_kernel(const float* x, int nx, const float* a,
                            const float* b, int nd, uint32_t* out_x,
                            uint32_t* out_d) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < nx) {
    float s, c, fs, fc;
    sincosf(x[i], &s, &c);
    fast_sincosf(x[i], fs, fc);
    uint32_t* o = out_x + 6 * i;
    o[0] = trig_ok(x[i]) ? 1u : 0u;
    o[1] = __float_as_uint(fs);
    o[2] = __float_as_uint(s);
    o[3] = __float_as_uint(fc);
    o[4] = __float_as_uint(c);
    o[5] = __float_as_uint(cosf(x[i]));
  }
  if (i < nd) {
    uint32_t* o = out_d + 3 * i;
    o[0] = div_ok(a[i], b[i]) ? 1u : 0u;
    o[1] = __float_as_uint(fast_div(a[i], b[i]));
    o[2] = __float_as_uint(a[i] / b[i]);
  }
}

constexpr int kBlocks = 132 * 16;
constexpr int kThreads = 256;

}  // namespace

// counts [5]: sin, cos (sincosf) and cosf mismatches, values outside
// trig_ok, all values that failed one of them; first [kFirst, 6]: x, sin,
// fast sin, cos, fast cos, cosf of the first failures. Both zeroed by the
// caller.
extern "C" int dust_check_trig(unsigned long long* counts, uint32_t* first,
                               void* stream) {
  const float bound = kTrigBound;
  uint32_t n_pos;  // the floats of [0, kTrigBound)
  memcpy(&n_pos, &bound, sizeof(n_pos));
  trig_kernel<<<kBlocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      n_pos, counts, first);
  return static_cast<int>(cudaGetLastError());
}

// counts [2]: mismatches, pairs outside div_ok; first [kFirst, 4]: a, b,
// a / b, fast_div(a, b) of the first mismatches. Both zeroed by the caller.
extern "C" int dust_check_div(int mode, unsigned long long n,
                              unsigned long long* counts, uint32_t* first,
                              void* stream) {
  div_kernel<<<kBlocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      mode, n, counts, first);
  return static_cast<int>(cudaGetLastError());
}

// out_x [nx, 6]: trig_ok, fast sin, sin, fast cos, cos, cosf; out_d [nd,
// 3]: div_ok, fast_div, a / b
extern "C" int dust_check_eval(const float* x, int nx, const float* a,
                               const float* b, int nd, uint32_t* out_x,
                               uint32_t* out_d, void* stream) {
  const int n = nx > nd ? nx : nd;
  if (n > 0)
    eval_kernel<<<(n + 127) / 128, 128, 0,
                  static_cast<cudaStream_t>(stream)>>>(x, nx, a, b, nd,
                                                       out_x, out_d);
  return static_cast<int>(cudaGetLastError());
}
