// Shared by every kernel source of the port: each source builds into its own
// shared library with a plain C interface, loaded from Python with ctypes.
#pragma once

#include <cuda_runtime.h>

#define REPRO_THREADS 256

// Grid size for `work` items at REPRO_THREADS threads a block.
static inline unsigned int repro_grid(long long work) {
  return static_cast<unsigned int>((work + REPRO_THREADS - 1) / REPRO_THREADS);
}

// The wrapper turns a non-zero launch status into a Python error; this gives
// it CUDA's own text for the code.
extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
