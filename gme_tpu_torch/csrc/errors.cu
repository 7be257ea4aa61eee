// Error text for the codes the launchers return.
#include "gme_kernels.cuh"

GME_API const char* gme_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
