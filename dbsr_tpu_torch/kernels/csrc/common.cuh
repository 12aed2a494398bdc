// Shared by every kernel library: the C export macro, the error string
// entry that the Python binding (dbsr_tpu_torch/kernels/__init__.py) reads,
// and the cp.async helpers of the kernels that stage tiles with it. Each
// .cu file is built into its own shared library and includes this once.
#pragma once

#include <cuda_runtime.h>

#define DBSR_EXPORT extern "C" __attribute__((visibility("default")))

DBSR_EXPORT const char* dbsr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// cp.async of kBytes (4 or 16) with src_bytes of them read, the rest zeros
template <int kBytes>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(src_bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(src_bytes));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most kPending committed groups are still in flight
template <int kPending = 0>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending));
}
