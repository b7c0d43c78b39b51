// Error reporting shared by every entry point of the kernel library.
#include "common.cuh"

extern "C" const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
