// CUDA error text for the kernels' launch codes (the wrappers raise with it).
#include <cuda_runtime.h>

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
