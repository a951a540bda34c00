// Host code that launches the kernels of the register-resident core
// (ntt_core_kernels.cuh), shared by pbs_kernels.cu (K2, K6) and
// single_cta_kernels.cu (K4, K7): the core's limits, the variant that
// takes LJ digit polynomials, the shared-memory opt-in and the cluster
// launch.  Each answer the device gives is asked for once and cached, so a
// launch costs the host the launch call alone.
#pragma once

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <type_traits>
#include <utility>

#include "ntt_core_kernels.cuh"

namespace tfhe_core {

inline int log2_int(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

// cudaErrorInvalidValue unless a kernel on the core takes LJ digit
// polynomials, N and P primes; 0 if it does
inline int core_refuses(int LJ, int N, int P) {
  const int log_n = log2_int(N);
  return (1 << log_n) != N || log_n < kMinLogN || log_n > kMaxLogN ||
                 LJ < 1 || LJ > kMaxDigitPolys || P < 1 ||
                 P > tfhe_pbs::kMaxPrimes
             ? (int)cudaErrorInvalidValue
             : 0;
}

// the shared memory of external_product_prime: max(LJ, OM) polynomials
inline size_t product_smem(int LJ, int OM, int N) {
  return (size_t)(LJ > OM ? LJ : OM) * N * sizeof(uint32_t);
}

// f(std::integral_constant<int, LJ_MAX>) for the kernels' variant that
// takes LJ digit polynomials: 2, 4, 9 or kMaxDigitPolys
template <class F>
int by_digit_polys(int LJ, F f) {
  if (LJ <= 2) return f(std::integral_constant<int, 2>{});
  if (LJ <= 4) return f(std::integral_constant<int, 4>{});
  if (LJ <= 9) return f(std::integral_constant<int, 9>{});
  return f(std::integral_constant<int, kMaxDigitPolys>{});
}

// Lets `kernel` take `smem` bytes of dynamic shared memory on the current
// device: cudaErrorInvalidValue beyond the device's limit, and the opt-in
// above 48 KB.  The limit is read once per device, the opt-in made once
// per kernel, device and larger size.
inline int allow_smem(const void* kernel, size_t smem) {
  static std::mutex mu;
  static std::map<int, size_t> limits;
  static std::map<std::pair<const void*, int>, size_t> allowed;
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  std::lock_guard<std::mutex> lock(mu);
  auto lim = limits.find(dev);
  if (lim == limits.end()) {
    int limit = 0;
    err = (int)cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err) return err;
    lim = limits.emplace(dev, (size_t)limit).first;
  }
  if (smem > lim->second) return (int)cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return 0;
  size_t& have = allowed[{kernel, dev}];
  if (smem <= have) return 0;
  err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (!err) have = smem;
  return err;
}

// One cluster of P CTAs of N/8 threads per ciphertext, the batch on
// grid.x; attr is the configuration's storage.
inline cudaLaunchConfig_t cluster_config(int B, int P, int N, size_t smem,
                                         cudaStream_t st,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)((long long)B * P));
  config.blockDim = dim3(N / kRadix);
  config.dynamicSmemBytes = smem;
  config.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return config;
}

template <typename... Params, typename... Args>
int launch_clusters(void (*kernel)(Params...), int B, int P, int N,
                    size_t smem, cudaStream_t st, Args... args) {
  int err = allow_smem((const void*)kernel, smem);
  if (err) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t config = cluster_config(B, P, N, smem, st, attr);
  err = (int)cudaLaunchKernelEx(&config, kernel, args...);
  if (err) return err;
  return (int)cudaGetLastError();
}

// One CTA of N/8 threads per ciphertext, the batch on grid.x
template <typename... Params, typename... Args>
int launch_ctas(void (*kernel)(Params...), int B, int N, size_t smem,
                cudaStream_t st, Args... args) {
  const int err = allow_smem((const void*)kernel, smem);
  if (err) return err;
  kernel<<<(unsigned)B, N / kRadix, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace tfhe_core
