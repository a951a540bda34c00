// Multi-bit blind-rotation step kernels for Hopper (sm_90a): the port's
// counterparts of the Pallas kernels of `tfhe_tpu/ops/fused_multibit.py`.
//
//   multibit_combine_kernel  <- K8 singles_kernel (:747) + combine_kernel
//                               (:776) of fused_multibit_rotate_scan (:702)
//   ntt_mac_kernel<true> +
//   crt_accumulate_kernel<false>  <- K8 mac_kernel (:823) -> _mb_mac_math
//                               (:583), in pbs_kernels.cuh
//   rotate_decompose_kernel<false> <- K8 mac_kernel's _dec_limbs (:264)
//   multibit_step_kernel     <- K9 step_kernel (:539) of
//                               fused_multibit_rotate_scan1 (:508) ->
//                               _mb_step_math_onekernel (:368)
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
//   kshoup    [per, P, LJ, O, M, N] uint32 their Shoup companions (step)
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
// multibit_step never writes the combined key: it reorders the MAC as
//     sum_j X^{d_j} (sum_lj D_lj K_j),
// so each K_j keeps its Shoup companion and the monomial is the table's
// operand with its own companion; it trades the combined key's device-memory
// round trip for per-subset MACs against keys read from L2.
#pragma once

#include <stdint.h>

#include "pbs_kernels.cuh"

namespace tfhe_pbs {

constexpr int kMaxSubsets = 16;     // 2^gf for gf <= 4
constexpr int kMaxOutputs = 8;      // O*M: G <= 4 output polynomials, 2 planes
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

// K9: one block per (ciphertext, prime).  Digits mod p -> forward NTT ->
// sum_j X^{d_j} (sum_lj D_lj K_j) -> inverse NTT -> residues, as
// ntt_mac_kernel; crt_accumulate_kernel<false> follows.  Each thread takes
// whole coefficients n with all O*M outputs, so one monomial gather (from
// the padded shared copy of the powers) serves O*M products.
__global__ void multibit_step_kernel(const int32_t* __restrict__ digits,
                                     const int32_t* __restrict__ d,
                                     const uint32_t* __restrict__ kspec,
                                     const uint32_t* __restrict__ kshoup,
                                     const uint32_t* __restrict__ powers,
                                     const int32_t* __restrict__ exps,
                                     const uint32_t* __restrict__ tables,
                                     uint32_t* __restrict__ residues, int per,
                                     int LJ, int O, int M, int N, int log_n) {
  extern __shared__ uint32_t smem[];
  __shared__ int ds[kMaxSubsets];
  const int b = blockIdx.x;
  const int pi = blockIdx.y;
  const int P = gridDim.y;
  const int OM = O * M;
  const int shift = log_n - 4;
  const uint32_t* tab = tables + (long long)pi * 5 * N;
  const uint32_t ninv = tab[4 * N];
  const uint32_t ninv_sh = tab[4 * N + 1];
  const uint32_t p = tab[4 * N + 2];
  const int mask2n = 2 * N - 1;
  uint32_t* dsp = smem;               // [LJ, N] digit spectra
  uint32_t* osp = smem + LJ * N;      // [O*M, N] output spectra
  uint32_t* pw = osp + OM * N;        // padded psi^k, then companions
  const uint32_t* pwsh = pw + 2 * N + 32;

  if (threadIdx.x < per) ds[threadIdx.x] = d[(long long)b * per + threadIdx.x];
  load_powers_smem(pw, powers + (long long)pi * 4 * N, N, shift);
  const int32_t* dig = digits + (long long)b * LJ * N;
  for (int idx = threadIdx.x; idx < LJ * N; idx += blockDim.x) {
    int32_t r = dig[idx] % (int32_t)p;
    dsp[idx] = (uint32_t)(r < 0 ? r + (int32_t)p : r);
  }
  __syncthreads();
  ntt_forward_smem(dsp, LJ, N, log_n, tab, tab + N, p);

  const long long W = (long long)LJ * OM * N;  // one subset's key, one prime
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const int e = exps[n];
    uint32_t s[kMaxOutputs];
#pragma unroll
    for (int om = 0; om < kMaxOutputs; ++om) s[om] = 0;
    for (int j = 0; j < per; ++j) {
      const uint32_t* ks = kspec + ((long long)j * P + pi) * W + n;
      const uint32_t* ksh = kshoup + ((long long)j * P + pi) * W + n;
      uint32_t t[kMaxOutputs];
#pragma unroll
      for (int om = 0; om < kMaxOutputs; ++om) t[om] = 0;
      for (int lj = 0; lj < LJ; ++lj) {
        const uint32_t dv = dsp[lj * N + n];
#pragma unroll
        for (int om = 0; om < kMaxOutputs; ++om) {
          if (om < OM) {
            const long long k = ((long long)lj * OM + om) * N;
            t[om] = add_mod(t[om], mul_shoup(dv, ks[k], ksh[k], p), p);
          }
        }
      }
      if (j > 0) {
        const int m = pad_power((ds[j] * e) & mask2n, shift);
        const uint32_t w = pw[m];
        const uint32_t wsh = pwsh[m];
#pragma unroll
        for (int om = 0; om < kMaxOutputs; ++om) {
          if (om < OM) t[om] = mul_shoup(t[om], w, wsh, p);
        }
      }
#pragma unroll
      for (int om = 0; om < kMaxOutputs; ++om) {
        if (om < OM) s[om] = add_mod(s[om], t[om], p);
      }
    }
#pragma unroll
    for (int om = 0; om < kMaxOutputs; ++om) {
      if (om < OM) osp[om * N + n] = s[om];
    }
  }
  __syncthreads();
  ntt_inverse_smem(osp, OM, N, log_n, tab + 2 * N, tab + 3 * N, p);

  for (int idx = threadIdx.x; idx < OM * N; idx += blockDim.x) {
    const int n = idx & (N - 1);
    const int om = idx >> log_n;
    residues[(((long long)b * OM + om) * P + pi) * N + n] =
        mul_shoup(osp[idx], ninv, ninv_sh, p);
  }
}

}  // namespace tfhe_pbs
