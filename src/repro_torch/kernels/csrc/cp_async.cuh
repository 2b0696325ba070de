// 4-byte cp.async copies into shared memory, shared by the kernels that
// stage rows word by word (fused_read.cu, key_search.cu, log_replay.cu):
// node-image rows are 1,273 words at the default geometry, a 5,092-byte
// stride, so only 4-byte copies are aligned for every row.  A thread sees
// the words it copied itself after cp_async_wait_all; other threads of the
// block see them after a barrier.
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

// Commit every copy this thread issued and wait for all of them.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
