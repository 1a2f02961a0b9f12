// The text of a CUDA error code, for the wrappers' exceptions.
#include <cuda_runtime.h>

extern "C" const char* kd_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
