// Plain C entry point for the cluster blind-rotation kernel, loaded by
// tfhe_tpu_torch/ops/fused_pbs.py with ctypes: `blind_rotate_persistent`
// (K5, grid) calls it with all n steps.
// As in pbs_kernels.cu it launches on the caller's stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError() (0 on
// success).  A layout beyond the kernel's limits (more than kMaxPrimes
// primes, so more than 8 CTAs in a cluster, or more shared memory than the
// device allows a block) launches nothing and returns cudaErrorInvalidValue.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libstep_kernels.so step_kernels.cu
#include <cuda_runtime.h>

#include "step_kernels.cuh"

namespace {

int log2_int(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

}  // namespace

extern "C" int tfhe_blind_rotate_cluster(
    const void* acc_in, const void* ahat, const void* kspec,
    const void* kshoup, const void* tables, const void* crt, void* acc_out,
    int B, int n_steps, int G, int M, int P, int N, int base_log, int levels,
    int bits, void* stream) {
  const int kInvalid = (int)cudaErrorInvalidValue;
  if (P < 1 || P > tfhe_pbs::kMaxPrimes) return kInvalid;
  const size_t smem = (size_t)G * N * sizeof(int64_t) +
                      (size_t)(levels * G + G * M) * N * sizeof(uint32_t);
  int dev = 0, limit = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err) return err;
  if (smem > (size_t)limit) return kInvalid;
  if (smem > 48 * 1024) {
    err = (int)cudaFuncSetAttribute(
        tfhe_pbs::blind_rotate_cluster_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err) return err;
  }

  cudaLaunchConfig_t config = {};
  // one cluster of P CTAs per ciphertext; the batch rides on grid.x
  config.gridDim = dim3((unsigned)((long long)B * P));
  config.blockDim = dim3(N >= 1024 ? 512 : N / 2);
  config.dynamicSmemBytes = smem;
  config.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = (int)cudaLaunchKernelEx(
      &config, tfhe_pbs::blind_rotate_cluster_kernel, (const int64_t*)acc_in,
      (const int32_t*)ahat, (const uint32_t*)kspec, (const uint32_t*)kshoup,
      (const uint32_t*)tables, (const int64_t*)crt, (int64_t*)acc_out, B,
      n_steps, G, M, N, log2_int(N), base_log, levels, bits);
  if (err) return err;
  return (int)cudaGetLastError();
}
