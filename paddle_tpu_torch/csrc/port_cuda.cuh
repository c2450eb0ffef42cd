// Shared plumbing of the port's CUDA sources: every kernel library built by
// paddle_tpu_torch/ops/_cuda.py exports this error-string helper beside its
// own entry point, so the Python wrapper can name a failed launch.
#pragma once

#include <cuda_runtime.h>

extern "C" const char* port_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
