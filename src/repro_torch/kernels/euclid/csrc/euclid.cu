// The non-template part of the euclid library: error strings for the
// Python wrapper. The instantiations are generated units that include
// euclid.cuh and expand EUCLID_INSTANTIATE once per tuning-space point.
#include <cuda_runtime.h>

extern "C" const char* euclid_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
