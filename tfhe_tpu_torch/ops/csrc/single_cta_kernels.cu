// Plain C entry point for the single-CTA blind-rotation kernels, loaded by
// tfhe_tpu_torch/ops/fused_pbs.py with ctypes: `pbs_step_single_cta` (K4,
// scan1w) calls it with one step and wide = 1, `blind_rotate_single_cta`
// (K7, mega) with all of them and wide = 0.  As in pbs_kernels.cu it
// launches on the caller's stream, does not synchronise, allocates nothing,
// and returns cudaGetLastError() (0 on success).  A layout beyond the
// kernel's limits (more than kMaxPrimes primes, or more shared memory than
// the device allows a block) launches nothing and returns
// cudaErrorInvalidValue.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libsingle_cta_kernels.so single_cta_kernels.cu
#include <cuda_runtime.h>

#include "single_cta_kernels.cuh"

namespace {

int log2_int(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

template <bool kWide>
int launch(const void* acc_in, const void* ahat, const void* kspec,
           const void* kshoup, const void* tables, const void* xcrt,
           void* acc_out, int B, int n_steps, int G, int M, int P, int N,
           int base_log, int levels, int bits, cudaStream_t st) {
  const int kInvalid = (int)cudaErrorInvalidValue;
  if (P < 1 || P > tfhe_pbs::kMaxPrimes) return kInvalid;
  const size_t LJ = (size_t)levels * G, OM = (size_t)G * M;
  const size_t smem = (size_t)G * N * sizeof(uint64_t) +
                      (OM + 2 * LJ + (kWide ? OM : 1)) * N * sizeof(uint32_t);
  int dev = 0, limit = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err) return err;
  if (smem > (size_t)limit) return kInvalid;
  if (smem > 48 * 1024) {
    err = (int)cudaFuncSetAttribute(
        tfhe_pbs::blind_rotate_single_cta_kernel<kWide>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err) return err;
  }
  // one CTA per ciphertext; the batch rides on grid.x
  tfhe_pbs::blind_rotate_single_cta_kernel<kWide>
      <<<(unsigned)B, N >= 1024 ? 512 : N / 2, smem, st>>>(
          (const int64_t*)acc_in, (const int32_t*)ahat,
          (const uint32_t*)kspec, (const uint32_t*)kshoup,
          (const uint32_t*)tables, (const int64_t*)xcrt, (int64_t*)acc_out,
          B, n_steps, G, M, P, N, log2_int(N), base_log, levels, bits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tfhe_blind_rotate_single_cta(
    const void* acc_in, const void* ahat, const void* kspec,
    const void* kshoup, const void* tables, const void* xcrt, void* acc_out,
    int B, int n_steps, int G, int M, int P, int N, int base_log, int levels,
    int bits, int wide, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (wide)
    return launch<true>(acc_in, ahat, kspec, kshoup, tables, xcrt, acc_out, B,
                        n_steps, G, M, P, N, base_log, levels, bits, st);
  return launch<false>(acc_in, ahat, kspec, kshoup, tables, xcrt, acc_out, B,
                       n_steps, G, M, P, N, base_log, levels, bits, st);
}
