// Plain C entry points for the blind-rotation step kernels, loaded by
// tfhe_tpu_torch/ops/fused_pbs.py with ctypes.  Each launches on the caller's
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 on success) so the wrapper can raise on a refused
// launch.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libpbs_kernels.so pbs_kernels.cu
#include <cuda_runtime.h>

#include "pbs_kernels.cuh"

namespace {

int log2_int(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

}  // namespace

extern "C" int tfhe_rotate_decompose(const void* acc, const void* ahat,
                                     void* digits, int B, int G, int N,
                                     int base_log, int levels, int bits,
                                     void* stream) {
  const long long total = (long long)B * G * N;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  tfhe_pbs::rotate_decompose_kernel<true><<<blocks, threads, 0,
                                      (cudaStream_t)stream>>>(
      (const int64_t*)acc, (const int32_t*)ahat, (int32_t*)digits, B, G, N,
      base_log, levels, bits);
  return (int)cudaGetLastError();
}

extern "C" int tfhe_external_product_crt(
    const void* digits, const void* kspec, const void* kshoup,
    const void* tables, const void* crt, const void* acc, void* residues,
    void* out, int B, int LJ, int O, int M, int P, int N, int bits,
    void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = (size_t)(LJ + O * M) * N * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        tfhe_pbs::ntt_mac_kernel<false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int mac_threads = N >= 1024 ? 512 : N / 2;
  // the batch rides on grid.x (up to 2^31 - 1 blocks), the primes on grid.y
  tfhe_pbs::ntt_mac_kernel<false><<<dim3(B, P), mac_threads, smem, st>>>(
      (const int32_t*)digits, (const uint32_t*)kspec, (const uint32_t*)kshoup,
      (const uint32_t*)tables, (uint32_t*)residues, LJ, O, M, N, log2_int(N));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const long long total = (long long)B * O * N;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  tfhe_pbs::crt_accumulate_kernel<true><<<blocks, threads, 0, st>>>(
      (const uint32_t*)residues, (const int64_t*)crt, (const int64_t*)acc,
      (int64_t*)out, B, O, M, P, N, bits);
  return (int)cudaGetLastError();
}
