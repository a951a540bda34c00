// Plain C entry points for the multi-bit step kernels, loaded by
// tfhe_tpu_torch/ops/fused_multibit.py with ctypes.  As in pbs_kernels.cu,
// each launches on the caller's stream, does not synchronise, allocates
// nothing, and returns cudaGetLastError() (0 on success).  A layout beyond
// the kernels' limits (kMaxSubsets, kMaxOutputs, N < 32, or more shared
// memory than the device allows a block) launches nothing and returns
// cudaErrorInvalidValue; the Python wrappers check only dtypes and shapes.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libmultibit_kernels.so multibit_kernels.cu
#include <cuda_runtime.h>

#include "multibit_kernels.cuh"

namespace {

int log2_int(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

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

// Dynamic plus static shared memory above 48 KiB needs the opt-in; the
// static part is at most the subsets' degrees (multibit_step_kernel).
// Beyond the device's opt-in limit the launch is rejected as kInvalid.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  const size_t total = smem + sizeof(int) * tfhe_pbs::kMaxSubsets;
  if (total <= 48 * 1024) return 0;
  int dev = 0, limit = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err) return err;
  if (total > (size_t)limit) return kInvalid;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

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
  int err = allow_smem(tfhe_pbs::multibit_combine_kernel, smem);
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
  int err = allow_smem(tfhe_pbs::ntt_mac_kernel<true>, smem);
  if (err) return err;
  tfhe_pbs::ntt_mac_kernel<true><<<dim3(B, P), ntt_threads(N), smem, st>>>(
      (const int32_t*)digits, (const uint32_t*)combined, nullptr,
      (const uint32_t*)tables, (uint32_t*)residues, LJ, O, M, N, log2_int(N),
      0, P);
  err = (int)cudaGetLastError();
  if (err) return err;
  return crt_replace(residues, crt, out, B, O, M, P, N, bits, st);
}

extern "C" int tfhe_multibit_step(const void* digits, const void* d,
                                  const void* kspec, const void* kshoup,
                                  const void* powers, const void* exps,
                                  const void* tables, const void* crt,
                                  void* residues, void* out, int B, int per,
                                  int LJ, int O, int M, int P, int N, int bits,
                                  void* stream) {
  if (!layout_ok(per, O * M, N)) return kInvalid;
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t smem =
      (size_t)(LJ + O * M) * N * sizeof(uint32_t) + power_table_bytes(N);
  int err = allow_smem(tfhe_pbs::multibit_step_kernel, smem);
  if (err) return err;
  tfhe_pbs::multibit_step_kernel<<<dim3(B, P), ntt_threads(N), smem, st>>>(
      (const int32_t*)digits, (const int32_t*)d, (const uint32_t*)kspec,
      (const uint32_t*)kshoup, (const uint32_t*)powers, (const int32_t*)exps,
      (const uint32_t*)tables, (uint32_t*)residues, per, LJ, O, M, N,
      log2_int(N));
  err = (int)cudaGetLastError();
  if (err) return err;
  return crt_replace(residues, crt, out, B, O, M, P, N, bits, st);
}
