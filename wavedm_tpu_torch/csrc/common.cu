// Library-wide C entries of libwavedm_tpu_torch_kernels.so.
//
// wavedm_src_hash: the hash of the sources this library was built from
// (ops/_build.py passes it as -DWAVEDM_SRC_HASH and finds the string in the
// file to decide whether a rebuild is needed).
#include <cuda_runtime.h>

#define WAVEDM_STR2(x) #x
#define WAVEDM_STR(x) WAVEDM_STR2(x)
#ifndef WAVEDM_SRC_HASH
#define WAVEDM_SRC_HASH unversioned
#endif

extern "C" const char wavedm_src_hash[] =
    "wavedm-src-hash=" WAVEDM_STR(WAVEDM_SRC_HASH);

extern "C" const char* wavedm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
