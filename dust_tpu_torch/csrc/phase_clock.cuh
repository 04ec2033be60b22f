// The clocked builds of the kernels (K2, K3, K4/K5, K6, K7, K8, K9/K10):
// thread 0 adds the clock64 cycles between the block barriers that close
// the phases of a step, summed over the steps, then writes one row per
// block: the phases' cycles, the whole loop's cycles and its %globaltimer
// nanoseconds (ops/phase_clock.py reads the rows). With kOn false a
// PhaseClock is empty: no barrier, no clock read, no store, so the timed
// build carries no clock code.

#pragma once

#include <cuda_runtime.h>

namespace dust_clock {

__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<long long>(t);
}

// acc: kPhases slots of shared memory, thread 0's running sums.
template <bool kOn, int kPhases>
struct PhaseClock {
  long long* acc;
  long long t_last = 0, t0 = 0, ns0 = 0;

  __device__ explicit PhaseClock(long long* shared) : acc(shared) {
    if constexpr (kOn) {
      if (threadIdx.x == 0) {
        for (int p = 0; p < kPhases; ++p) acc[p] = 0;
        t0 = t_last = clock64();
        ns0 = global_ns();
      }
    }
  }

  // Closes phase p: a block barrier, then thread 0 adds the cycles since
  // the previous mark.
  __device__ __forceinline__ void mark(int p) {
    if constexpr (kOn) {
      __syncthreads();
      if (threadIdx.x == 0) {
        const long long now = clock64();
        acc[p] += now - t_last;
        t_last = now;
      }
    }
  }

  // Thread 0 writes row[0 .. kPhases + 2).
  __device__ void write(long long* row) const {
    if constexpr (kOn) {
      if (threadIdx.x == 0) {
        for (int p = 0; p < kPhases; ++p) row[p] = acc[p];
        row[kPhases] = clock64() - t0;
        row[kPhases + 1] = global_ns() - ns0;
      }
    }
  }
};

}  // namespace dust_clock
