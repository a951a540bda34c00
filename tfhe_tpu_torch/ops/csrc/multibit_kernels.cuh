// Multi-bit blind-rotation step kernels of K8 for Hopper (sm_90a): the
// port's counterparts of the Pallas kernels of
// `tfhe_tpu/ops/fused_multibit.py` that schedule "scan3" runs.
//
//   multibit_combine_kernel  <- K8 singles_kernel (:747) + combine_kernel
//                               (:776) of fused_multibit_rotate_scan (:702)
//   ntt_mac_kernel<true> +
//   crt_accumulate_kernel<false>  <- K8 mac_kernel (:823) -> _mb_mac_math
//                               (:583), in pbs_kernels.cuh
//   rotate_decompose_kernel<false> <- K8 mac_kernel's _dec_limbs (:264)
//
// K9, schedule "scan1", runs on the register-resident core instead:
// multibit_step_cluster_kernel (multibit_core.cuh), one launch a group step.
// Its first port here, multibit_step_kernel, was the old shared-memory
// core's last multi-bit user besides K8's external product.
//
// One group step of gf mask elements replaces the accumulator by the
// external product of the combined GGSW
//     K = K_0 + sum_{j >= 1} X^{d_j} K_j
// with the accumulator, where K_j is the key of subset j (bit gf-1-i of j
// selects mask element i) and d_j the switched subset sum.  The spectrum of
// X^d at position n is psi^(d * e(n) mod 2N) (ops/ntt.py), a gather from the
// table of the 2N powers of psi, so the combination costs one Shoup product
// per subset and coefficient, and no transform of the key.  The TPU built
// composite monomials from products of singletons with an epsilon
// correction only because Mosaic has no gather; here every subset gathers
// its own.
//
// Layouts (all dense), beyond those of pbs_kernels.cuh:
//   d         [B, per]              int32  d_j mod 2N, per = 2^gf subsets
//   kspec     [per, P, LJ, O, M, N] uint32 one group's subset key spectra
//   powers    [P, 2, 2N]            uint32 psi^k and Shoup companions
//   exps      [N]                   int32  e(n)
//   combined  [B, P, LJ, O, M, N]   uint32 per-ciphertext combined key
//
// What bounds them on the card: multibit_combine reads the group's key
// spectra once per kCombineBatch ciphertexts and writes the
// combined key, 320 KiB per ciphertext at N = 2048, and is bound by that
// write.  The external product with the combined key does the
// NTT work of K2's first port, bound by latency in the shared-memory NTTs
// (PERF.md section 6), with Barrett products in its MAC.
#pragma once

#include <stdint.h>

#include "pbs_kernels.cuh"

namespace tfhe_pbs {

constexpr int kMaxSubsets = 16;     // 2^gf for gf <= 4
constexpr int kMaxOutputs = 8;      // O*M: G <= 4 output polynomials, 2 planes
                                    // (K9's limit)
constexpr int kCombineBatch = 16;   // ciphertexts per multibit_combine thread

// Position of psi^t in the padded shared-memory copy of the power table.
// The 32 lanes of a warp hold 32 consecutive coefficients n, whose
// exponents e(n) = 2 bitrev(n) + 1 differ by multiples of N/16, so
// unpadded the gathered t = d * e(n) mod 2N of a warp fall in one bank (a
// 32-way conflict).  One word of padding per N/16 words (shift =
// log2(N) - 4) spreads them over 32 banks; the padded table holds 2N + 32
// words.
__device__ __forceinline__ int pad_power(int t, int shift) {
  return t + (t >> shift);
}

// Copies one prime's powers of psi and their Shoup companions (2 x 2N
// words) into shared memory at their padded positions.
__device__ __forceinline__ void load_powers_smem(uint32_t* dst,
                                                 const uint32_t* src, int N,
                                                 int shift) {
  const int padded = 2 * N + 32;
  for (int i = threadIdx.x; i < 2 * N; i += blockDim.x) {
    dst[pad_power(i, shift)] = src[i];
    dst[padded + pad_power(i, shift)] = src[2 * N + i];
  }
}

// K8 singles + combine: one thread per key word (idx < W = LJ*O*M*N) of
// one prime and kCombineBatch ciphertexts (grid.z), so each subset key word
// is read once per kCombineBatch ciphertexts; the gathers hit the padded
// shared-memory copy of the powers, whose companions make each product a
// Shoup product (the key's companions are not needed).  Writes
// K_0 + sum_j X^{d_j} K_j in canonical residues.
__global__ void multibit_combine_kernel(const int32_t* __restrict__ d,
                                        const uint32_t* __restrict__ kspec,
                                        const uint32_t* __restrict__ powers,
                                        const int32_t* __restrict__ exps,
                                        const uint32_t* __restrict__ tables,
                                        uint32_t* __restrict__ combined, int B,
                                        int per, int W, int N, int log_n) {
  extern __shared__ uint32_t smem[];  // padded psi^k, then companions
  const int pi = blockIdx.y;
  const int P = gridDim.y;
  const int shift = log_n - 4;
  const uint32_t p = tables[(long long)pi * 5 * N + 4 * N + 2];
  load_powers_smem(smem, powers + (long long)pi * 4 * N, N, shift);
  __syncthreads();
  const uint32_t* pw = smem;
  const uint32_t* pwsh = smem + 2 * N + 32;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= W) return;

  const int e = exps[idx & (N - 1)];
  const int mask2n = 2 * N - 1;
  uint32_t k[kMaxSubsets];
#pragma unroll
  for (int j = 0; j < kMaxSubsets; ++j) {
    if (j < per) k[j] = kspec[((long long)j * P + pi) * W + idx];
  }
  const int b_end = min(B, (int)(blockIdx.z + 1) * kCombineBatch);
  for (int b = blockIdx.z * kCombineBatch; b < b_end; ++b) {
    const int32_t* db = d + (long long)b * per;
    uint32_t c = k[0];
#pragma unroll
    for (int j = 1; j < kMaxSubsets; ++j) {
      if (j < per) {
        const int t = pad_power((db[j] * e) & mask2n, shift);
        c = add_mod(c, mul_shoup(k[j], pw[t], pwsh[t], p), p);
      }
    }
    combined[((long long)b * P + pi) * W + idx] = c;
  }
}

}  // namespace tfhe_pbs
