// Plain C entry point for the Shoup spectrum MAC (K10), loaded by
// tfhe_tpu_torch/ops/shoup_mac.py with ctypes.  It launches on the caller's
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 on success) so the wrapper can raise on a refused
// launch.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libshoup_mac_kernels.so shoup_mac_kernels.cu
#include <cuda_runtime.h>

#include "shoup_mac_kernels.cuh"

extern "C" int tfhe_shoup_mac(const void* a, const void* ks, const void* ksh,
                              void* out, long long B, int LJ, int GM, int N,
                              int p, void* stream) {
  const long long total = B * GM * N;
  if (total <= 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  tfhe_shoup::shoup_mac_kernel<<<(unsigned)blocks, threads, 0,
                                 (cudaStream_t)stream>>>(
      (const int32_t*)a, (const int32_t*)ks, (const int32_t*)ksh,
      (int32_t*)out, total, LJ, GM, N, p);
  return (int)cudaGetLastError();
}
