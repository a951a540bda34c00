// Plain C entry points for the single-CTA blind-rotation kernels, loaded by
// tfhe_tpu_torch/ops/fused_pbs.py with ctypes.  `pbs_step_single_cta` (K4,
// scan1w) calls tfhe_blind_rotate_single_cta with one step and wide = 1,
// which launches blind_rotate_single_cta_kernel (single_cta_kernels.cuh) on
// the tables ntt.tables_for(N).kernel; `blind_rotate_single_cta` (K7, mega)
// with all of them and wide = 0, which launches blind_rotate_core_kernel or
// blind_rotate_cluster_core_kernel (ntt_core_kernels.cuh) on the tables
// ntt.pass_tables_for(N), and refuses as well LJ beyond
// tfhe_core::kMaxDigitPolys and N outside 256 ... 2048.
// tfhe_blind_rotate_single_cta_form says which of K7's two kernels a batch
// gets.  As in pbs_kernels.cu the launches go on the caller's stream, do
// not synchronise, allocate nothing, and return cudaGetLastError() (0 on
// success).  A layout beyond the kernel's limits (more than kMaxPrimes
// primes, or more shared memory than the device allows a block) launches
// nothing and returns cudaErrorInvalidValue.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libsingle_cta_kernels.so single_cta_kernels.cu
#include <cuda_runtime.h>

#include <type_traits>

#include "ntt_core_kernels.cuh"
#include "single_cta_kernels.cuh"

namespace {

int log2_int(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

// K4: one CTA per ciphertext on the shared-memory core
int launch_wide(const void* acc_in, const void* ahat, const void* kspec,
                const void* kshoup, const void* tables, const void* xcrt,
                void* acc_out, int B, int n_steps, int G, int M, int P, int N,
                int base_log, int levels, int bits, cudaStream_t st) {
  const int kInvalid = (int)cudaErrorInvalidValue;
  if (P < 1 || P > tfhe_pbs::kMaxPrimes) return kInvalid;
  const size_t LJ = (size_t)levels * G, OM = (size_t)G * M;
  const size_t smem = (size_t)G * N * sizeof(uint64_t) +
                      (2 * OM + 2 * LJ) * N * sizeof(uint32_t);
  int dev = 0, limit = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err) return err;
  if (smem > (size_t)limit) return kInvalid;
  if (smem > 48 * 1024) {
    err = (int)cudaFuncSetAttribute(
        tfhe_pbs::blind_rotate_single_cta_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err) return err;
  }
  // one CTA per ciphertext; the batch rides on grid.x
  tfhe_pbs::blind_rotate_single_cta_kernel
      <<<(unsigned)B, N >= 1024 ? 512 : N / 2, smem, st>>>(
          (const int64_t*)acc_in, (const int32_t*)ahat,
          (const uint32_t*)kspec, (const uint32_t*)kshoup,
          (const uint32_t*)tables, (const int64_t*)xcrt, (int64_t*)acc_out,
          B, n_steps, G, M, P, N, log2_int(N), base_log, levels, bits);
  return (int)cudaGetLastError();
}

int allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// K7 on the register-resident core: blind_rotate_core_kernel (a CTA per
// ciphertext, the primes in turn) or blind_rotate_cluster_core_kernel (a
// cluster of P CTAs per ciphertext, one prime each), whichever should
// finish first.  A launch runs in waves of the CTAs (clusters) that fit on
// the device at once, and a cluster's wave takes about 1 / (0.7 P) of a
// single-CTA wave: on an H100 (132 SMs), 17.2 against 50.6 ms at
// PARAM_MESSAGE_2_CARRY_2_KS_PBS width (742 steps) and 22.2 against 89.4
// ms at boolean DEFAULT_PARAMETERS width (722 steps), B = 64
// (kernel_times.py).  So the clusters run when ceil(B / clusters that fit)
// < 0.7 P ceil(B / CTAs that fit): at B = 64 at both widths, and at
// B = 256 for boolean (3 waves of 105 clusters) but not for shortint (5
// waves of 52 clusters against one of 264 CTAs).

// The core's limits, and the shared memory of its two forms: the
// accumulator, the digits and the exchange buffer; the single CTA keeps
// the explicit CRT's fractions besides.
int core_layout(int G, int M, int P, int N, int levels, size_t* smem,
                size_t* cluster_smem) {
  const int LJ = levels * G, OM = G * M;
  const int log_n = log2_int(N);
  if (P < 1 || P > tfhe_pbs::kMaxPrimes || (1 << log_n) != N ||
      log_n < tfhe_core::kMinLogN || log_n > tfhe_core::kMaxLogN ||
      LJ < 1 || LJ > tfhe_core::kMaxDigitPolys)
    return (int)cudaErrorInvalidValue;
  *cluster_smem = (size_t)G * N * sizeof(uint64_t) +
                  (size_t)(LJ + (LJ > OM ? LJ : OM)) * N * sizeof(uint32_t);
  *smem = *cluster_smem + (size_t)OM * N * sizeof(uint32_t);
  int dev = 0, limit = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err) return err;
  return *smem > (size_t)limit ? (int)cudaErrorInvalidValue : 0;
}

// f(std::integral_constant<int, LJ_MAX>) for the kernels' variant that
// takes LJ digit polynomials
template <class F>
int by_digit_polys(int LJ, F f) {
  if (LJ <= 2) return f(std::integral_constant<int, 2>{});
  if (LJ <= 4) return f(std::integral_constant<int, 4>{});
  return f(std::integral_constant<int, tfhe_core::kMaxDigitPolys>{});
}

// The cluster form's launch: one cluster of P CTAs per ciphertext, the
// batch on grid.x; attr is the configuration's storage.
cudaLaunchConfig_t cluster_config(int B, int P, int N, size_t smem,
                                  cudaStream_t st,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)((long long)B * P));
  config.blockDim = dim3(N / tfhe_core::kRadix);
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

// *cluster = 1 if a batch of B runs as clusters, 0 as single CTAs
template <int LJ_MAX>
int pick_form(int B, int P, int N, size_t smem, size_t cluster_smem,
              int* cluster) {
  auto single = tfhe_core::blind_rotate_core_kernel<LJ_MAX>;
  auto split = tfhe_core::blind_rotate_cluster_core_kernel<LJ_MAX>;
  int err = allow_smem((const void*)single, smem);
  if (!err) err = allow_smem((const void*)split, cluster_smem);
  if (err) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t config =
      cluster_config(B, P, N, cluster_smem, 0, attr);
  int dev = 0, sms = 0, per_sm = 0, clusters = 0;
  err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, single, N / tfhe_core::kRadix, smem);
  if (!err)
    err = (int)cudaOccupancyMaxActiveClusters(&clusters, split, &config);
  if (err) return err;
  const long long waves_single =
      per_sm > 0 ? (B + (long long)per_sm * sms - 1) / ((long long)per_sm * sms)
                 : -1;
  const long long waves_split = clusters > 0 ? (B + clusters - 1) / clusters
                                             : -1;
  *cluster = waves_split > 0 && (waves_single < 0 ||
                                 10 * waves_split < 7 * P * waves_single);
  return 0;
}

template <int LJ_MAX>
int launch_core_as(const void* acc_in, const void* ahat, const void* kspec,
                   const void* kshoup, const void* tables, const void* xcrt,
                   void* acc_out, int B, int n_steps, int G, int M, int P,
                   int N, int base_log, int levels, int bits, size_t smem,
                   size_t cluster_smem, cudaStream_t st) {
  int cluster = 0;
  int err = pick_form<LJ_MAX>(B, P, N, smem, cluster_smem, &cluster);
  if (err) return err;
  if (cluster) {
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t config =
        cluster_config(B, P, N, cluster_smem, st, attr);
    err = (int)cudaLaunchKernelEx(
        &config, tfhe_core::blind_rotate_cluster_core_kernel<LJ_MAX>,
        (const int64_t*)acc_in, (const int32_t*)ahat, (const uint32_t*)kspec,
        (const uint32_t*)kshoup, (const uint32_t*)tables,
        (const int64_t*)xcrt, (int64_t*)acc_out, B, n_steps, G, M, N,
        log2_int(N), base_log, levels, bits);
    if (err) return err;
    return (int)cudaGetLastError();
  }
  // one CTA per ciphertext; the batch rides on grid.x
  tfhe_core::blind_rotate_core_kernel<LJ_MAX>
      <<<(unsigned)B, N / tfhe_core::kRadix, smem, st>>>(
          (const int64_t*)acc_in, (const int32_t*)ahat,
          (const uint32_t*)kspec, (const uint32_t*)kshoup,
          (const uint32_t*)tables, (const int64_t*)xcrt, (int64_t*)acc_out,
          B, n_steps, G, M, P, N, log2_int(N), base_log, levels, bits);
  return (int)cudaGetLastError();
}

int launch_core(const void* acc_in, const void* ahat, const void* kspec,
                const void* kshoup, const void* tables, const void* xcrt,
                void* acc_out, int B, int n_steps, int G, int M, int P, int N,
                int base_log, int levels, int bits, cudaStream_t st) {
  size_t smem = 0, cluster_smem = 0;
  const int err = core_layout(G, M, P, N, levels, &smem, &cluster_smem);
  if (err) return err;
  return by_digit_polys(levels * G, [&](auto lj_max) {
    return launch_core_as<decltype(lj_max)::value>(
        acc_in, ahat, kspec, kshoup, tables, xcrt, acc_out, B, n_steps, G, M,
        P, N, base_log, levels, bits, smem, cluster_smem, st);
  });
}

}  // namespace

extern "C" int tfhe_blind_rotate_single_cta(
    const void* acc_in, const void* ahat, const void* kspec,
    const void* kshoup, const void* tables, const void* xcrt, void* acc_out,
    int B, int n_steps, int G, int M, int P, int N, int base_log, int levels,
    int bits, int wide, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (wide)
    return launch_wide(acc_in, ahat, kspec, kshoup, tables, xcrt, acc_out,
                       B, n_steps, G, M, P, N, base_log, levels, bits, st);
  return launch_core(acc_in, ahat, kspec, kshoup, tables, xcrt, acc_out, B,
                     n_steps, G, M, P, N, base_log, levels, bits, st);
}

// *cluster = 1 if K7 (wide = 0) runs a batch of B as
// blind_rotate_cluster_core_kernel, 0 if as blind_rotate_core_kernel;
// cudaErrorInvalidValue for a layout the core refuses.
extern "C" int tfhe_blind_rotate_single_cta_form(int B, int G, int M, int P,
                                                 int N, int levels,
                                                 int* cluster) {
  size_t smem = 0, cluster_smem = 0;
  const int err = core_layout(G, M, P, N, levels, &smem, &cluster_smem);
  if (err) return err;
  return by_digit_polys(levels * G, [&](auto lj_max) {
    return pick_form<decltype(lj_max)::value>(B, P, N, smem, cluster_smem,
                                              cluster);
  });
}
