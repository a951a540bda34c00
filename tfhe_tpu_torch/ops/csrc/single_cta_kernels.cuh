// Whole blind-rotation steps on one thread block (CTA) per ciphertext, for
// Hopper (sm_90a): the port's counterpart of the two TPU schedules of
// `tfhe_tpu/ops/fused_pbs.py` that run every prime of a step in one body.
//
//   blind_rotate_single_cta_kernel<true>, one step per launch
//       <- fused_blind_rotate_scan1w (:965) -> step_kernel (:983)
//          -> _primes_crt_math_wide (:826)                             (K4)
//   blind_rotate_single_cta_kernel<false>, all n steps in one launch
//       <- fused_blind_rotate_planes (:1545) -> _make_kernel (:1403)
//          -> _step_math (:755), _prime_block (:672)                   (K7)
//
// One CTA owns one ciphertext and holds its accumulator [G, N] in shared
// memory.  A step (single_cta_step):
//   1. the signed gadget digits of acc * X^a - acc into shared memory, once
//      (rotate_decompose's math);
//   2. for each prime in turn: the digits mod p, the forward NTTs of the LJ
//      digit polynomials, the MAC against the step's key spectra with Shoup
//      products, the inverse NTTs, and the explicit CRT's running sums:
//      acc += c * (Q/p mod 2^64) in place, and the fixed-point fraction
//      frac += c * round(2^28/p), with c = r * N^-1 (Q/p)^-1 mod p for the
//      unscaled inverse transform r (ops/ntt.py `_explicit_crt_host`);
//   3. the correction acc -= round(frac) * Q per output plane (the
//      reference's `_crt_accumulate`, :709).
// kWide (K4): the MAC writes all O*M output spectra of a prime, and one
// inverse-NTT pass transforms them together, as K4 batches them in lanes.
// Otherwise (K7): one output at a time, MAC, inverse NTT and CRT sums,
// as `_prime_block` does per om; its spectrum buffer is one polynomial, so
// at N = 2048 two CTAs fit on an SM where K4's layout fits one.
// The primes run in turn inside the CTA, as the TPU bodies run them: no
// cluster, no residue exchange, and no residues kept past their prime.
//
// Layouts are those of pbs_kernels.cuh:
//   acc_in, acc_out [B, G, N] int64; ahat [n, B] int32 in [0, 2N];
//   kspec, kshoup [n, P, LJ, O, M, N] uint32; tables [P, 5, N];
//   xcrt [P, 6] int64 (p, w, w's Shoup companion, Q/p mod 2^64,
//   round(2^28/p), Q mod 2^64).
// Shared memory: G*N*8 (accumulator) + O*M*N*4 (fractions) + 2*LJ*N*4
// (digits, digit spectra) + (kWide ? O*M : 1)*N*4 (output spectra): 128 KB
// (K4) and 104 KB (K7) at PARAM_MESSAGE_2_CARRY_2_KS_PBS, 60 and 56 KB at
// boolean DEFAULT_PARAMETERS.
//
// What bounds it on the card: integer issue in the NTTs, as K2 and the
// cluster kernel.  Per step device memory sees only the key slice
// [P, LJ, O, M, N] (shared by every ciphertext, so mostly from L2).
#pragma once

#include <stdint.h>

#include "pbs_kernels.cuh"

namespace tfhe_pbs {

constexpr int kXcrtWidth = 6;
constexpr int kFracBits = 28;

// One output spectrum (or kWide: all O*M) of one prime:
// osp[om', n] = sum_lj dsp[lj, n] * key[lj, om, n] mod p for om in
// [om0, om0 + count).
__device__ __forceinline__ void spectrum_mac(const uint32_t* dsp,
                                             uint32_t* osp,
                                             const uint32_t* __restrict__ ks,
                                             const uint32_t* __restrict__ ksh,
                                             int LJ, int OM, int om0,
                                             int count, int N, int log_n,
                                             uint32_t p) {
  for (int idx = threadIdx.x; idx < count * N; idx += blockDim.x) {
    const int n = idx & (N - 1);
    const long long col = (long long)(om0 + (idx >> log_n)) * N + n;
    uint32_t s = 0;
    for (int lj = 0; lj < LJ; ++lj) {
      const long long k = (long long)lj * OM * N + col;
      s = add_mod(s, mul_shoup(dsp[lj * N + n], ks[k], ksh[k], p), p);
    }
    osp[idx] = s;
  }
  __syncthreads();
}

// The explicit CRT's running sums for output om of one prime, from its
// unscaled inverse transform r: c = r * w mod p, acc[o] += c * q_i in plane
// m (shifted by 32 m bits), frac[om] += c * t.  The caller arranges that no
// two threads add into one accumulator word at once.
__device__ __forceinline__ void crt_add(uint64_t* acc, uint32_t* frac,
                                        uint32_t r, int o, int m, int om,
                                        int n, int N, uint32_t p, uint32_t w,
                                        uint32_t wsh, uint64_t q_i,
                                        uint32_t t) {
  const uint32_t c = mul_shoup(r, w, wsh, p);
  frac[om * N + n] += c * t;
  acc[o * N + n] += ((uint64_t)c * q_i) << (32 * m);
}

// One step of the blind rotation of this CTA's ciphertext; `a` is the
// modulus-switched mask element in [0, 2N).  On entry acc holds the
// accumulator and frac is zero; on return acc holds
// acc + GGSW (x) (acc * X^a - acc) and frac is zero again.
template <bool kWide>
__device__ __forceinline__ void single_cta_step(
    uint64_t* acc, uint32_t* frac, int32_t* dig, uint32_t* dsp,
    uint32_t* osp, int a, const uint32_t* __restrict__ kspec,
    const uint32_t* __restrict__ kshoup, const uint32_t* __restrict__ tables,
    const int64_t* __restrict__ xcrt, int G, int M, int P, int N, int log_n,
    int base_log, int levels, int bits) {
  const int LJ = levels * G;
  const int OM = G * M;
  const uint64_t mask = bits == 64 ? ~0ull : 0xFFFFFFFFull;

  // 1. the digits of acc * X^a - acc
  for (int idx = threadIdx.x; idx < G * N; idx += blockDim.x) {
    const int g = idx >> log_n;
    const int j = idx & (N - 1);
    decompose_word(rotated_diff((const int64_t*)acc + g * N, a, j, N, mask),
                   base_log, levels, bits, mask,
                   [&](int lvl, int32_t digit) {
                     dig[(lvl * G + g) * N + j] = digit;
                   });
  }
  __syncthreads();

  // 2. each prime's external product and its share of the CRT
  const long long kblock = (long long)LJ * OM * N;
  for (int pi = 0; pi < P; ++pi) {
    const uint32_t* tab = tables + (long long)pi * 5 * N;
    const int64_t* row = xcrt + pi * kXcrtWidth;
    const uint32_t p = (uint32_t)row[0];
    const uint32_t w = (uint32_t)row[1];
    const uint32_t wsh = (uint32_t)row[2];
    const uint64_t q_i = (uint64_t)row[3];
    const uint32_t t = (uint32_t)row[4];
    const uint32_t* ks = kspec + pi * kblock;
    const uint32_t* ksh = kshoup + pi * kblock;

    for (int idx = threadIdx.x; idx < LJ * N; idx += blockDim.x) {
      const int32_t r = dig[idx] % (int32_t)p;
      dsp[idx] = (uint32_t)(r < 0 ? r + (int32_t)p : r);
    }
    __syncthreads();
    ntt_forward_smem(dsp, LJ, N, log_n, tab, tab + N, p);

    if constexpr (kWide) {
      spectrum_mac(dsp, osp, ks, ksh, LJ, OM, 0, OM, N, log_n, p);
      ntt_inverse_smem(osp, OM, N, log_n, tab + 2 * N, tab + 3 * N, p);
      // one thread per accumulator word, both of its planes
      for (int idx = threadIdx.x; idx < G * N; idx += blockDim.x) {
        const int o = idx >> log_n;
        const int n = idx & (N - 1);
        for (int m = 0; m < M; ++m)
          crt_add(acc, frac, osp[(o * M + m) * N + n], o, m, o * M + m, n, N,
                  p, w, wsh, q_i, t);
      }
    } else {
      for (int om = 0; om < OM; ++om) {
        spectrum_mac(dsp, osp, ks, ksh, LJ, OM, om, 1, N, log_n, p);
        ntt_inverse_smem(osp, 1, N, log_n, tab + 2 * N, tab + 3 * N, p);
        for (int n = threadIdx.x; n < N; n += blockDim.x)
          crt_add(acc, frac, osp[n], om / M, om % M, om, n, N, p, w, wsh,
                  q_i, t);
        __syncthreads();  // osp is rewritten by the next output's MAC
      }
    }
    __syncthreads();  // dsp is rewritten by the next prime
  }

  // 3. the correction by round(frac) * Q, plane by plane
  const uint64_t q = (uint64_t)xcrt[5];
  for (int idx = threadIdx.x; idx < G * N; idx += blockDim.x) {
    const int o = idx >> log_n;
    const int n = idx & (N - 1);
    uint64_t v = acc[idx];
    for (int m = 0; m < M; ++m) {
      uint32_t* f = frac + (o * M + m) * N + n;
      const uint64_t k = (*f + (1u << (kFracBits - 1))) >> kFracBits;
      v -= (k * q) << (32 * m);
      *f = 0;
    }
    acc[idx] = v & mask;
  }
  __syncthreads();
}

// n_steps steps of the blind rotation; CTA b owns ciphertext b.  kspec /
// kshoup hold the n_steps steps' keys and ahat their [n_steps, B] mask
// elements.  acc_out may not alias acc_in.
template <bool kWide>
__global__ void blind_rotate_single_cta_kernel(
    const int64_t* __restrict__ acc_in, const int32_t* __restrict__ ahat,
    const uint32_t* __restrict__ kspec, const uint32_t* __restrict__ kshoup,
    const uint32_t* __restrict__ tables, const int64_t* __restrict__ xcrt,
    int64_t* __restrict__ acc_out, int B, int n_steps, int G, int M, int P,
    int N, int log_n, int base_log, int levels, int bits) {
  extern __shared__ __align__(16) unsigned char single_smem[];
  const long long b = blockIdx.x;
  const int LJ = levels * G;
  const int OM = G * M;
  uint64_t* acc = (uint64_t*)single_smem;     // [G, N]
  uint32_t* frac = (uint32_t*)(acc + G * N);  // [O*M, N]
  int32_t* dig = (int32_t*)(frac + OM * N);   // [LJ, N] signed digits
  uint32_t* dsp = (uint32_t*)(dig + LJ * N);  // [LJ, N] digit spectra
  uint32_t* osp = dsp + LJ * N;               // [O*M or 1, N] outputs

  const int64_t* src = acc_in + b * G * N;
  for (int idx = threadIdx.x; idx < G * N; idx += blockDim.x)
    acc[idx] = (uint64_t)src[idx];
  for (int idx = threadIdx.x; idx < OM * N; idx += blockDim.x) frac[idx] = 0;
  __syncthreads();

  const long long step_words = (long long)P * LJ * OM * N;
  for (int s = 0; s < n_steps; ++s) {
    const int a = ahat[(long long)s * B + b] & (2 * N - 1);  // 2N is 0
    single_cta_step<kWide>(acc, frac, dig, dsp, osp, a,
                           kspec + s * step_words, kshoup + s * step_words,
                           tables, xcrt, G, M, P, N, log_n, base_log, levels,
                           bits);
  }

  int64_t* dst = acc_out + b * G * N;
  for (int idx = threadIdx.x; idx < G * N; idx += blockDim.x)
    dst[idx] = (int64_t)acc[idx];
}

}  // namespace tfhe_pbs
