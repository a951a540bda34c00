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
//   tfhe_ntt_mac_prime         K6 (scan3): ntt_mac_prime_kernel
//                              (ntt_core_kernels.cuh), one prime, on
//                              ntt.pass_tables_for(N)
//   tfhe_crt_accumulate        K6 (scan3): the CRT into the accumulator
//
// The kernels on the core take LJ <= tfhe_core::kMaxDigitPolys and
// 256 <= N <= 2048; a layout beyond that, or more shared memory than the
// device allows a block, launches nothing and returns
// cudaErrorInvalidValue.  The opt-in to more than 48 KB of shared memory
// is made once per kernel and device, so a launch costs the host the
// launch call alone.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libpbs_kernels.so pbs_kernels.cu
#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>

#include "core_launch.cuh"
#include "pbs_kernels.cuh"

namespace {

using tfhe_core::log2_int;

// *clusters = how many clusters of `cluster` CTAs of `kernel` (N/8 threads,
// smem bytes each) the current device holds at once: asked of the
// occupancy API once per kernel, device, N and size, then cached.
template <typename... Params>
int max_clusters(void (*kernel)(Params...), int cluster, int N, size_t smem,
                 int* clusters) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int, size_t>, int> known;
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  const auto key = std::make_tuple((const void*)kernel, dev, N, smem);
  {
    std::lock_guard<std::mutex> lock(mu);
    const auto it = known.find(key);
    if (it != known.end()) {
      *clusters = it->second;
      return 0;
    }
  }
  err = tfhe_core::allow_smem((const void*)kernel, smem);
  if (err) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t config =
      tfhe_core::cluster_config(1, cluster, N, smem, 0, attr);
  err = (int)cudaOccupancyMaxActiveClusters(clusters, kernel, &config);
  if (err) return err;
  std::lock_guard<std::mutex> lock(mu);
  known[key] = *clusters;
  return 0;
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
  (void)residues;
  const int err = tfhe_core::core_refuses(LJ, N, P);
  if (err) return err;
  return tfhe_core::by_digit_polys(LJ, [&](auto lj_max) {
    return tfhe_core::launch_clusters(
        tfhe_core::external_product_cluster_kernel<decltype(lj_max)::value>,
        B, P, N, tfhe_core::product_smem(LJ, O * M, N),
        (cudaStream_t)stream,
        (const int32_t*)digits, (const uint32_t*)kspec,
        (const uint32_t*)kshoup, (const uint32_t*)tables,
        (const int64_t*)crt, (const int64_t*)acc, (int64_t*)out, LJ, O, M, N,
        log2_int(N), bits);
  });
}

// kspec / kshoup: prime `prime`'s block [LJ, O, M, N] of one step's key;
// residues [B, O, M, P, N], of which this launch writes prime `prime`'s rows.
// A pair of CTAs per ciphertext when the batch's pairs all fit on the
// device at once, else one CTA per ciphertext.
extern "C" int tfhe_ntt_mac_prime(const void* digits, const void* kspec,
                                  const void* kshoup, const void* tables,
                                  void* residues, int B, int LJ, int O, int M,
                                  int P, int N, int prime, void* stream) {
  const int err = tfhe_core::core_refuses(LJ, N, P);
  if (err) return err;
  if (prime < 0 || prime >= P) return (int)cudaErrorInvalidValue;
  const size_t smem = tfhe_core::product_smem(LJ, O * M, N);
  return tfhe_core::by_digit_polys(LJ, [&](auto lj_max) {
    constexpr int kLJ = decltype(lj_max)::value;
    auto pair = tfhe_core::ntt_mac_prime_kernel<kLJ, 2>;
    auto single = tfhe_core::ntt_mac_prime_kernel<kLJ, 1>;
    int pairs = 0;
    const int e = max_clusters(pair, 2, N, smem, &pairs);
    if (e) return e;
    const cudaStream_t st = (cudaStream_t)stream;
    if (B <= pairs)
      return tfhe_core::launch_clusters(
          pair, B, 2, N, smem, st, (const int32_t*)digits,
          (const uint32_t*)kspec, (const uint32_t*)kshoup,
          (const uint32_t*)tables, (uint32_t*)residues, LJ, O * M, N,
          log2_int(N), prime, P);
    return tfhe_core::launch_ctas(
        single, B, N, smem, st, (const int32_t*)digits,
        (const uint32_t*)kspec, (const uint32_t*)kshoup,
        (const uint32_t*)tables, (uint32_t*)residues, LJ, O * M, N,
        log2_int(N), prime, P);
  });
}

extern "C" int tfhe_crt_accumulate(const void* residues, const void* crt,
                                   const void* acc, void* out, int B, int O,
                                   int M, int P, int N, int bits,
                                   void* stream) {
  return launch_crt_accumulate(residues, crt, acc, out, B, O, M, P, N, bits,
                               (cudaStream_t)stream);
}
