// Plain C entry points for the multi-bit step kernels, loaded by
// tfhe_tpu_torch/ops/fused_multibit.py with ctypes.  As in pbs_kernels.cu,
// each launches on the caller's stream, does not synchronise, allocates
// nothing, and returns cudaGetLastError() (0 on success).  A layout beyond
// the kernels' limits (kMaxSubsets, kMaxOutputs, N < 32, the core's limits
// for K9, or more shared memory than the device allows a block) launches
// nothing and returns cudaErrorInvalidValue; the Python wrappers check only
// dtypes and shapes.
//
//   tfhe_decompose, tfhe_multibit_combine,
//   tfhe_multibit_external_product      K8 (scan3), multibit_kernels.cuh
//   tfhe_multibit_step                  K9 (scan1), multibit_core.cuh
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libmultibit_kernels.so multibit_kernels.cu
#include <cuda_runtime.h>

#include "core_launch.cuh"
#include "multibit_core.cuh"
#include "multibit_kernels.cuh"

namespace {

using tfhe_core::allow_smem;
using tfhe_core::log2_int;

int ntt_threads(int N) { return N >= 1024 ? 512 : N / 2; }

// the padded shared copy of one prime's powers of psi and companions
size_t power_table_bytes(int N) {
  return (size_t)2 * (2 * N + 32) * sizeof(uint32_t);
}

// the zero-based CRT of the residues into a fresh accumulator
int crt_replace(const void* residues, const void* crt, void* out, int B,
                int O, int M, int P, int N, int bits, cudaStream_t st) {
  const long long total = (long long)B * O * N;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  tfhe_pbs::crt_accumulate_kernel<false><<<blocks, threads, 0, st>>>(
      (const uint32_t*)residues, (const int64_t*)crt, nullptr, (int64_t*)out,
      B, O, M, P, N, bits);
  return (int)cudaGetLastError();
}

const int kInvalid = (int)cudaErrorInvalidValue;

// The layouts the multi-bit kernels hold in registers and padded tables:
// at most kMaxSubsets subsets and, for the step, kMaxOutputs outputs.
bool layout_ok(int per, int outputs, int N) {
  return per >= 1 && per <= tfhe_pbs::kMaxSubsets && outputs >= 1 &&
         outputs <= tfhe_pbs::kMaxOutputs && N >= 32;
}

}  // namespace

extern "C" int tfhe_decompose(const void* acc, void* digits, int B, int G,
                              int N, int base_log, int levels, int bits,
                              void* stream) {
  const long long total = (long long)B * G * N;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  tfhe_pbs::rotate_decompose_kernel<false><<<blocks, threads, 0,
                                             (cudaStream_t)stream>>>(
      (const int64_t*)acc, nullptr, (int32_t*)digits, B, G, N, base_log,
      levels, bits);
  return (int)cudaGetLastError();
}

extern "C" int tfhe_multibit_combine(const void* d, const void* kspec,
                                     const void* powers, const void* exps,
                                     const void* tables, void* combined,
                                     int B, int per, int P, int W, int N,
                                     void* stream) {
  if (!layout_ok(per, 1, N)) return kInvalid;
  const size_t smem = power_table_bytes(N);
  int err = allow_smem((const void*)tfhe_pbs::multibit_combine_kernel, smem);
  if (err) return err;
  const int threads = 256;
  const dim3 grid((W + threads - 1) / threads, P,
                  (B + tfhe_pbs::kCombineBatch - 1) / tfhe_pbs::kCombineBatch);
  tfhe_pbs::multibit_combine_kernel<<<grid, threads, smem,
                                      (cudaStream_t)stream>>>(
      (const int32_t*)d, (const uint32_t*)kspec, (const uint32_t*)powers,
      (const int32_t*)exps, (const uint32_t*)tables, (uint32_t*)combined, B,
      per, W, N, log2_int(N));
  return (int)cudaGetLastError();
}

extern "C" int tfhe_multibit_external_product(
    const void* digits, const void* combined, const void* tables,
    const void* crt, void* residues, void* out, int B, int LJ, int O, int M,
    int P, int N, int bits, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = (size_t)(LJ + O * M) * N * sizeof(uint32_t);
  int err = allow_smem((const void*)tfhe_pbs::ntt_mac_kernel<true>, smem);
  if (err) return err;
  tfhe_pbs::ntt_mac_kernel<true><<<dim3(B, P), ntt_threads(N), smem, st>>>(
      (const int32_t*)digits, (const uint32_t*)combined, nullptr,
      (const uint32_t*)tables, (uint32_t*)residues, LJ, O, M, N, log2_int(N),
      0, P);
  err = (int)cudaGetLastError();
  if (err) return err;
  return crt_replace(residues, crt, out, B, O, M, P, N, bits, st);
}

// K9: one group step, acc, out [B, G, N], d [B, per], kspec [per, P, LJ, G,
// 2, N] on the core's tables (ntt.pass_tables_for) and the explicit CRT's
// constants; a cluster of P CTAs per ciphertext.
extern "C" int tfhe_multibit_step(const void* acc, const void* d,
                                  const void* kspec, const void* powers,
                                  const void* exps, const void* tables,
                                  const void* xcrt, void* out, int B,
                                  int per, int G, int P, int N, int base_log,
                                  int levels, void* stream) {
  const int LJ = levels * G, OM = 2 * G;
  int err = tfhe_core::core_refuses(LJ, N, P);
  if (err) return err;
  if (!layout_ok(per, OM, N)) return kInvalid;
  return tfhe_core::by_digit_polys(LJ, [&](auto lj_max) {
    return tfhe_core::launch_clusters(
        tfhe_core::multibit_step_cluster_kernel<decltype(lj_max)::value>, B,
        P, N, tfhe_core::multibit_step_smem(LJ, OM, N), (cudaStream_t)stream,
        (const int64_t*)acc, (const int32_t*)d, (const uint32_t*)kspec,
        (const uint32_t*)powers, (const int32_t*)exps,
        (const uint32_t*)tables, (const int64_t*)xcrt, (int64_t*)out, per, G,
        N, log2_int(N), base_log, levels);
  });
}
