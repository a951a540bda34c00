// Plain C entry points for the blind-rotation step kernels, loaded by
// tfhe_tpu_torch/ops/fused_pbs.py with ctypes.  Each launches on the caller's
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 on success) so the wrapper can raise on a refused
// launch.
//
//   tfhe_rotate_decompose      K1, in the scan2 and scan3 schedules
//   tfhe_external_product_crt  K2 (scan2): ntt_mac over all primes, then CRT
//   tfhe_ntt_mac_prime         K6 (scan3): ntt_mac for one prime
//   tfhe_crt_accumulate        K6 (scan3): the CRT into the accumulator
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

int ntt_threads(int N) { return N >= 1024 ? 512 : N / 2; }

size_t ntt_mac_smem_bytes(int LJ, int O, int M, int N) {
  return (size_t)(LJ + O * M) * N * sizeof(uint32_t);
}

// Dynamic shared memory above 48 KiB needs the opt-in.
int allow_ntt_mac_smem(size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(tfhe_pbs::ntt_mac_kernel<false>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

int launch_ntt_mac(const void* digits, const void* kspec, const void* kshoup,
                   const void* tables, void* residues, int B, int LJ, int O,
                   int M, int P, int N, int prime0, int primes,
                   cudaStream_t st) {
  const size_t smem = ntt_mac_smem_bytes(LJ, O, M, N);
  int err = allow_ntt_mac_smem(smem);
  if (err) return err;
  // the batch rides on grid.x (up to 2^31 - 1 blocks), the primes on grid.y
  tfhe_pbs::ntt_mac_kernel<false><<<dim3(B, primes), ntt_threads(N), smem,
                                     st>>>(
      (const int32_t*)digits, (const uint32_t*)kspec, (const uint32_t*)kshoup,
      (const uint32_t*)tables, (uint32_t*)residues, LJ, O, M, N, log2_int(N),
      prime0, P);
  return (int)cudaGetLastError();
}

int launch_crt_accumulate(const void* residues, const void* crt,
                          const void* acc, void* out, int B, int O, int M,
                          int P, int N, int bits, cudaStream_t st) {
  const long long total = (long long)B * O * N;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  tfhe_pbs::crt_accumulate_kernel<true><<<blocks, threads, 0, st>>>(
      (const uint32_t*)residues, (const int64_t*)crt, (const int64_t*)acc,
      (int64_t*)out, B, O, M, P, N, bits);
  return (int)cudaGetLastError();
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
  int err = launch_ntt_mac(digits, kspec, kshoup, tables, residues, B, LJ, O,
                           M, P, N, 0, P, st);
  if (err) return err;
  return launch_crt_accumulate(residues, crt, acc, out, B, O, M, P, N, bits,
                               st);
}

// kspec / kshoup: prime `prime`'s block [LJ, O, M, N] of one step's key;
// residues [B, O, M, P, N], of which this launch writes prime `prime`'s rows.
extern "C" int tfhe_ntt_mac_prime(const void* digits, const void* kspec,
                                  const void* kshoup, const void* tables,
                                  void* residues, int B, int LJ, int O, int M,
                                  int P, int N, int prime, void* stream) {
  return launch_ntt_mac(digits, kspec, kshoup, tables, residues, B, LJ, O, M,
                        P, N, prime, 1, (cudaStream_t)stream);
}

extern "C" int tfhe_crt_accumulate(const void* residues, const void* crt,
                                   const void* acc, void* out, int B, int O,
                                   int M, int P, int N, int bits,
                                   void* stream) {
  return launch_crt_accumulate(residues, crt, acc, out, B, O, M, P, N, bits,
                               (cudaStream_t)stream);
}
