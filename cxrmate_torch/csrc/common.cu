// C interface shared by every kernel entry: the text of a cudaError_t.
#include <cuda_runtime.h>

extern "C" const char* cxr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
