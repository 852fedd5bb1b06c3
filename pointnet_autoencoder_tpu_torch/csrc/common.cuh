// Shared by every kernel library of the port. Each library is one
// translation unit, so the definitions below appear once per library.
#pragma once

#include <cuda_runtime.h>

// Message for a code returned by one of the library's C entry points.
extern "C" const char* pcae_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
