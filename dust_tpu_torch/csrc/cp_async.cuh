// Asynchronous copies from device memory to shared memory (cp.async),
// shared by the streamed kernels' column staging (stream_split.cuh) and
// K6's staging of the model and actions (particle.cuh,
// particle_rollout.cu). A thread's copies land once it has committed them
// and waited; a block barrier then shows them to the other threads.

#pragma once

#include <cuda_runtime.h>

namespace dust_async {

// 4 bytes (cached in L1 on the way).
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// 16 bytes; both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace dust_async
