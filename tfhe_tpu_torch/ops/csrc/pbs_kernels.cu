// Plain C entry points for the blind-rotation step kernels, loaded by
// tfhe_tpu_torch/ops/fused_pbs.py with ctypes.  Each launches on the caller's
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 on success) so the wrapper can raise on a refused
// launch.
//
//   tfhe_rotate_decompose      K1, in the scan2 and scan3 schedules
//   tfhe_external_product_crt  K2 (scan2): external_product_cluster_kernel
//                              (ntt_core_kernels.cuh), the transforms of all
//                              primes and the explicit CRT in one launch;
//                              `tables` is ntt.pass_tables_for(N), `crt` the
//                              explicit CRT's constants (NttTables.xcrt),
//                              `residues` is not read (may be null)
//   tfhe_ntt_mac_prime         K6 (scan3): ntt_mac for one prime
//   tfhe_crt_accumulate        K6 (scan3): the CRT into the accumulator
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libpbs_kernels.so pbs_kernels.cu
#include <cuda_runtime.h>

#include "ntt_core_kernels.cuh"
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

template <int LJ_MAX>
int launch_cluster_external_product_as(const void* digits, const void* kspec,
                                    const void* kshoup, const void* tables,
                                    const void* xcrt, const void* acc,
                                    void* out, int B, int LJ, int G, int M,
                                    int P, int N, int bits, size_t smem,
                                    cudaStream_t st) {
  auto kernel = tfhe_core::external_product_cluster_kernel<LJ_MAX>;
  if (smem > 48 * 1024) {
    const int err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err) return err;
  }
  cudaLaunchConfig_t config = {};
  // one cluster of P CTAs per ciphertext; the batch rides on grid.x
  config.gridDim = dim3((unsigned)((long long)B * P));
  config.blockDim = dim3(N / tfhe_core::kRadix);
  config.dynamicSmemBytes = smem;
  config.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const int err = (int)cudaLaunchKernelEx(
      &config, kernel, (const int32_t*)digits, (const uint32_t*)kspec,
      (const uint32_t*)kshoup, (const uint32_t*)tables, (const int64_t*)xcrt,
      (const int64_t*)acc, (int64_t*)out, LJ, G, M, N, log2_int(N), bits);
  if (err) return err;
  return (int)cudaGetLastError();
}

// K2 on the core in one launch: the transforms and the explicit CRT
int launch_cluster_external_product(const void* digits, const void* kspec,
                                    const void* kshoup, const void* tables,
                                    const void* xcrt, const void* acc,
                                    void* out, int B, int LJ, int G, int M,
                                    int P, int N, int bits, cudaStream_t st) {
  const int kInvalid = (int)cudaErrorInvalidValue;
  const int log_n = log2_int(N);
  const int OM = G * M;
  if ((1 << log_n) != N || log_n < tfhe_core::kMinLogN ||
      log_n > tfhe_core::kMaxLogN || LJ < 1 ||
      LJ > tfhe_core::kMaxDigitPolys || P < 1 || P > tfhe_pbs::kMaxPrimes)
    return kInvalid;
  const size_t smem = (size_t)(LJ > OM ? LJ : OM) * N * sizeof(uint32_t);
  int dev = 0, limit = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err) return err;
  if (smem > (size_t)limit) return kInvalid;
  if (LJ <= 2)
    return launch_cluster_external_product_as<2>(
        digits, kspec, kshoup, tables, xcrt, acc, out, B, LJ, G, M, P, N,
        bits, smem, st);
  if (LJ <= 4)
    return launch_cluster_external_product_as<4>(
        digits, kspec, kshoup, tables, xcrt, acc, out, B, LJ, G, M, P, N,
        bits, smem, st);
  return launch_cluster_external_product_as<tfhe_core::kMaxDigitPolys>(
      digits, kspec, kshoup, tables, xcrt, acc, out, B, LJ, G, M, P, N, bits,
      smem, st);
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

// LJ beyond tfhe_core::kMaxDigitPolys, N outside 256 ... 2048, or more
// shared memory than the device allows a block launches nothing and returns
// cudaErrorInvalidValue.
extern "C" int tfhe_external_product_crt(
    const void* digits, const void* kspec, const void* kshoup,
    const void* tables, const void* crt, const void* acc, void* residues,
    void* out, int B, int LJ, int O, int M, int P, int N, int bits,
    void* stream) {
  (void)residues;
  return launch_cluster_external_product(digits, kspec, kshoup, tables, crt,
                                         acc, out, B, LJ, O, M, P, N, bits,
                                         (cudaStream_t)stream);
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
