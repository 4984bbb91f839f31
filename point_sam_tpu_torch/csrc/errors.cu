// Error strings for the C entry points (each returns a cudaError_t code).
#include <cuda_runtime.h>

extern "C" const char* psam_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
