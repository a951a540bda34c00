// Plain C entry point for the Shoup spectrum MAC (K10), loaded by
// tfhe_tpu_torch/ops/shoup_mac.py with ctypes: the P primes of a step in
// one launch (P = 1 for the per-prime call).  It launches on the caller's
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 on success) so the wrapper can raise on a refused
// launch.  A layout beyond the kernel's limits (P outside 1 ... kMaxPrimes,
// LJ outside 1 ... kMaxLJ, N not a multiple of 4, a grid beyond 2^31 - 1
// blocks) launches nothing and returns cudaErrorInvalidValue.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libshoup_mac_kernels.so shoup_mac_kernels.cu
#include <cuda_runtime.h>

#include "shoup_mac_kernels.cuh"

namespace {

template <int LJ_MAX>
int launch(const void* a, const void* ks, const void* ksh, void* out,
           const tfhe_shoup::Primes& primes, int B, int LJ, int GM, int N,
           int P, cudaStream_t st) {
  using namespace tfhe_shoup;
  const long long tiles = (N + kWarpWords - 1) / kWarpWords;
  const long long blocks = (B + kRows - 1) / kRows * tiles;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  shoup_mac_kernel<LJ_MAX><<<dim3((unsigned)blocks, (unsigned)P),
                             dim3(32, kRows), 0, st>>>(
      (const int32_t*)a, (const int32_t*)ks, (const int32_t*)ksh,
      (int32_t*)out, primes, B, LJ, GM, N, P);
  return (int)cudaGetLastError();
}

}  // namespace

// a [P, B, LJ, N], ks / ksh [P, LJ, GM, N], out [B, GM, P, N], all int32
// and 16-byte aligned; primes[i] is prime i.
extern "C" int tfhe_shoup_mac(const void* a, const void* ks, const void* ksh,
                              void* out, const int* primes, int P, int B,
                              int LJ, int GM, int N, void* stream) {
  using tfhe_shoup::kMaxLJ;
  using tfhe_shoup::kMaxPrimes;
  if (P < 1 || P > kMaxPrimes || LJ < 1 || LJ > kMaxLJ || N < 1 ||
      N % tfhe_shoup::kVec != 0 || B < 0 || GM < 1)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  tfhe_shoup::Primes ps = {};
  for (int i = 0; i < P; ++i) ps.p[i] = primes[i];
  const cudaStream_t st = (cudaStream_t)stream;
  if (LJ <= 2) return launch<2>(a, ks, ksh, out, ps, B, LJ, GM, N, P, st);
  if (LJ <= 4) return launch<4>(a, ks, ksh, out, ps, B, LJ, GM, N, P, st);
  if (LJ <= 9) return launch<9>(a, ks, ksh, out, ps, B, LJ, GM, N, P, st);
  return launch<kMaxLJ>(a, ks, ksh, out, ps, B, LJ, GM, N, P, st);
}
