// Shared by every kernel library: the C export macro and the error string
// entry that the Python binding (dbsr_tpu_torch/kernels/__init__.py) reads.
// Each .cu file is built into its own shared library and includes this once.
#pragma once

#include <cuda_runtime.h>

#define DBSR_EXPORT extern "C" __attribute__((visibility("default")))

DBSR_EXPORT const char* dbsr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
