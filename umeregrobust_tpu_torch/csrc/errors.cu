// Error text for the codes the kernel entry points return.
#include "common.cuh"

UMR_EXPORT const char* umr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
