// Plain C entry points for the multi-bit step kernels, loaded by
// tfhe_tpu_torch/ops/fused_multibit.py with ctypes.  As in pbs_kernels.cu,
// each launches on the caller's stream, does not synchronise, allocates
// nothing, and returns cudaErrorInvalidValue, having launched nothing, for
// a layout beyond the kernels' limits (kMaxSubsets, kMaxOutputs, N < 256
// for the combine, the core's limits for the kernels on it, or more shared
// memory than the device allows a block), else cudaGetLastError() (0 on
// success); the Python wrappers check only dtypes, shapes and alignment.
//
//   tfhe_multibit_combine,
//   tfhe_multibit_external_product      K8 (scan3): multibit_kernels.cuh,
//                                       then multibit_core.cuh's kernel
//                                       with the combined key
//   tfhe_multibit_step                  K9 (scan1), multibit_core.cuh
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libmultibit_kernels.so multibit_kernels.cu
#include <cuda_runtime.h>

#include "core_launch.cuh"
#include "multibit_core.cuh"
#include "multibit_kernels.cuh"

namespace {

using tfhe_core::log2_int;

const int kInvalid = (int)cudaErrorInvalidValue;

// The layouts the multi-bit kernels take: at most kMaxSubsets subsets,
// one or two planes a torus word, and at most kMaxOutputs outputs G * M.
bool layout_ok(int per, int G, int M) {
  return per >= 1 && per <= tfhe_pbs::kMaxSubsets && (M == 1 || M == 2) &&
         G >= 1 && G * M <= tfhe_pbs::kMaxOutputs;
}

}  // namespace

// d [B, per], kspec [per, P, W], W = LJ O M N, combined [B, P, W], over
// the key's P primes; powers, exps ntt.monomial_tables_for(N, primes);
// tables ntt.pass_tables_for(N, primes) (their headers).  A block spans
// kCombineCols * 8 = 256 words of a row, so N >= 256; the tables hold N <=
// 2048.
extern "C" int tfhe_multibit_combine(const void* d, const void* kspec,
                                     const void* powers, const void* exps,
                                     const void* tables, void* combined,
                                     int B, int per, int P, int W, int N,
                                     void* stream) {
  constexpr int kSpan = tfhe_pbs::kCombineCols * tfhe_core::kRadix;
  const int batches =
      (B + tfhe_pbs::kCombineBatch - 1) / tfhe_pbs::kCombineBatch;
  if (!layout_ok(per, 1, 1) || (N & (N - 1)) || N < kSpan ||
      log2_int(N) > tfhe_core::kMaxLogN || W % N || batches > 65535)
    return kInvalid;
  const size_t smem = tfhe_pbs::combine_smem(per);
  const int err = tfhe_core::allow_smem(
      (const void*)tfhe_pbs::multibit_combine_kernel, smem);
  if (err) return err;
  tfhe_pbs::multibit_combine_kernel<<<
      dim3(N / kSpan, P, batches),
      dim3(tfhe_pbs::kCombineCols, tfhe_pbs::kCombineBatch), smem,
      (cudaStream_t)stream>>>(
      (const int32_t*)d, (const uint32_t*)kspec, (const uint32_t*)powers,
      (const int32_t*)exps, (const uint32_t*)tables, (uint32_t*)combined, B,
      per, W / N, N);
  return (int)cudaGetLastError();
}

// K8's external product from the accumulator: acc, out [B, G, N], combined
// [B, P, LJ, G, M, N] (multibit_combine's), on the core's tables
// (ntt.pass_tables_for) and the explicit CRT's constants of the key's P
// primes; a cluster of P CTAs per ciphertext, K9's kernel with one subset
// and the key per ciphertext.
extern "C" int tfhe_multibit_external_product(
    const void* acc, const void* combined, const void* tables,
    const void* xcrt, void* out, int B, int G, int M, int P, int N,
    int base_log, int levels, void* stream) {
  const int LJ = levels * G, OM = M * G;
  int err = tfhe_core::core_refuses(LJ, N, P);
  if (err) return err;
  if (!layout_ok(1, G, M)) return kInvalid;
  return tfhe_core::by_digit_polys(LJ, [&](auto lj_max) {
    return tfhe_core::launch_clusters(
        tfhe_core::multibit_step_cluster_kernel<decltype(lj_max)::value,
                                                true>,
        B, P, N, tfhe_core::multibit_step_smem(LJ, OM, N),
        (cudaStream_t)stream, (const int64_t*)acc, (const int32_t*)nullptr,
        (const uint32_t*)combined, (const uint32_t*)nullptr,
        (const int32_t*)nullptr, (const uint32_t*)tables,
        (const int64_t*)xcrt, (int64_t*)out, 1, G, M, N, log2_int(N),
        base_log, levels);
  });
}

// K9: one group step, acc, out [B, G, N], d [B, per], kspec [per, P, LJ, G,
// M, N] on the core's tables (ntt.pass_tables_for) and the explicit CRT's
// constants of the key's P primes; a cluster of P CTAs per ciphertext.
extern "C" int tfhe_multibit_step(const void* acc, const void* d,
                                  const void* kspec, const void* powers,
                                  const void* exps, const void* tables,
                                  const void* xcrt, void* out, int B,
                                  int per, int G, int M, int P, int N,
                                  int base_log, int levels, void* stream) {
  const int LJ = levels * G, OM = M * G;
  int err = tfhe_core::core_refuses(LJ, N, P);
  if (err) return err;
  if (!layout_ok(per, G, M)) return kInvalid;
  return tfhe_core::by_digit_polys(LJ, [&](auto lj_max) {
    return tfhe_core::launch_clusters(
        tfhe_core::multibit_step_cluster_kernel<decltype(lj_max)::value,
                                                false>,
        B, P, N, tfhe_core::multibit_step_smem(LJ, OM, N),
        (cudaStream_t)stream, (const int64_t*)acc, (const int32_t*)d,
        (const uint32_t*)kspec, (const uint32_t*)powers, (const int32_t*)exps,
        (const uint32_t*)tables, (const int64_t*)xcrt, (int64_t*)out, per, G,
        M, N, log2_int(N), base_log, levels);
  });
}
