// K1 and K6's last stage for Hopper (sm_90a), and the device functions the
// kernels on the register-resident core (ntt_core_kernels.cuh,
// multibit_core.cuh) share:
//
//   rotate_decompose_kernel  <- rot_kernel (:1229) -> _rot_dec_limbs (:614)
//                               of `tfhe_tpu/ops/fused_pbs.py:1213`
//                               (`fused_blind_rotate_scan2`), K1; also run
//                               by scan3 (:1489)
//   crt_accumulate_kernel    <- crt_kernel (:1520) -> _crt_accumulate (:709),
//                               K6's last stage
//
// Every NTT of the port runs on the register-resident core of ntt_core.cuh;
// the shared-memory core this file held until K8 moved off it (a radix-2
// loop with a barrier a stage) is gone.
//
// Integer arithmetic only; every result is bit-exact.  Layouts (all dense):
//   acc       [B, G, N]          int64  u64 torus words (u32: in [0, 2^32))
//   ahat      [B]                int32  modulus-switched mask element, [0, 2N]
//   digits    [B, L, G, N]       int32  signed gadget digits, level-major
//   xcrt      [P, 6]             int64  the explicit CRT's constants
//                                       (ntt.residue_crt_for)
//   residues  [B, O, M, P, N]    uint32 per-prime convolutions, canonical
// with O = G output polynomials, M key planes (two 32-bit planes of a u64
// key word, one for a u32 word) and P primes.
//
// What bounds them on the card: rotate_decompose moves 8 bytes in and
// 4*L bytes out per coefficient and is bound by memory; crt_accumulate
// reads the residues and the accumulator once and writes the accumulator
// once.
//
// K1, first design: one thread per output word, its (ciphertext,
// polynomial, coefficient) found with 64-bit `%` and `/` by a runtime N
// (a software division on the card), scalar 4-byte digit stores; 0.00353
// ms at PARAM_MESSAGE_2_CARRY_2_KS_PBS width and B = 64 on an H100, 3.8x
// its bound.  New: a thread owns kRotWords = 4 consecutive coefficients of
// one (ciphertext, polynomial) row, its indices 32-bit and taken from the
// grid with no division; it reads its own words as two 16-byte loads and
// the rotated source word by word (consecutive coefficients read
// consecutive source words, but at one wrap), decomposes the 4 words in
// lock step and stores each level's 4 digits as one 16-byte store.  8
// words a thread halved the threads and starved the card at small batches:
// 0.00290 ms at shortint width and 0.00332 at boolean DEFAULT_PARAMETERS
// width (B = 64), against 0.00225 and 0.00230 at 4 words.
//
// crt_accumulate, first design: one thread per output word, its indices
// found with 64-bit `%` and `/` by a runtime N, scalar 8-byte accumulator
// loads and stores, and a balanced Garner reconstruction: P(P-1)/2 = 10
// dependent Shoup products a plane and word, its table read as int64
// through generic loads; 0.01567 ms at PARAM_MESSAGE_2_CARRY_2_KS_PBS
// width and 0.00447 at boolean DEFAULT_PARAMETERS width (B = 64) on an
// H100, 3.6x and 4.2x its bound.  New: a thread owns kCrtWords = 4
// consecutive coefficients of one (ciphertext, output polynomial) row, its
// indices 32-bit and taken from the grid, as K1; each (plane, prime)
// residue quad is one 16-byte load, the accumulator two 16-byte loads and
// two 16-byte stores; and the CRT is the core's explicit one (crt_word),
// its constants held in registers: c_i = r_i (Q/p_i)^-1 mod p_i, one
// Shoup product a prime (the residues are canonical, already scaled by
// N^-1), then P independent 64-bit multiply-adds and one rounding a plane.
// Exact on its inputs for the reason K2's CRT is (ntt._explicit_crt_host):
// the residues are those of a convolution below 2^67 in magnitude; P
// residues drawn at random name an integer up to Q/2 ~ 2^76, where the
// 28-bit fraction may round the wrong way.  72 registers, no spill; blocks
// of 128 threads (2-4% faster than 256).  On an H100: 0.00565 ms at
// shortint width and 0.00330 at boolean width (B = 64; 1.3x and 3.1x the
// bound, the latter near a launch's floor), 0.0281 and 0.0048 at B = 256
// (first design 0.0575 and 0.0123).
#pragma once

#include <stdint.h>

namespace tfhe_pbs {

constexpr int kMaxPrimes = 8;
// the explicit CRT's constants per prime (ntt._explicit_crt_host): p, w,
// w's Shoup companion, Q/p mod 2^64, round(2^kFracBits / p), Q mod 2^64
constexpr int kXcrtWidth = 6;
constexpr int kFracBits = 28;
// coefficients a K1 thread owns
constexpr int kRotWords = 4;
// coefficients a crt_accumulate thread owns: one 16-byte load of each
// (plane, prime) residue quad
constexpr int kCrtWords = 4;

// a * w mod p for any 32-bit a and 0 <= w < p < 2^31, with
// wsh = floor(w * 2^32 / p): the quotient estimate is off by at most one, so
// the 32-bit remainder lies in [0, 2p) and one subtraction lands it.
__device__ __forceinline__ uint32_t mul_shoup(uint32_t a, uint32_t w,
                                              uint32_t wsh, uint32_t p) {
  uint32_t q = __umulhi(a, wsh);
  uint32_t r = a * w - q * p;
  return r >= p ? r - p : r;
}

// Coefficient j of acc * X^a - acc for one GLWE polynomial `row`, masked to
// the torus width, for a in [0, 2N): coefficient j of acc * X^a is
// +-acc[(j - a) mod N], negated when (j - a) mod 2N wraps past N (X^N == -1).
__device__ __forceinline__ uint64_t rotated_diff(const int64_t* row, int a,
                                                 int j, int N, uint64_t mask) {
  const int t = (j - a) & (2 * N - 1);
  uint64_t v = (uint64_t)row[t & (N - 1)];
  if (t >= N) v = 0ull - v;
  return (v - (uint64_t)row[j]) & mask;
}

// The signed gadget decompositions of kW torus words in lock step
// (tfhe_tpu/ops/decomposition.py:24-87, on each word): emit(level, dg) for
// each of the `levels` levels, smallest weight first, dg[k] the digit of
// word k; level index 0 is the largest.
template <int kW, typename Emit>
__device__ __forceinline__ void decompose_words(const uint64_t (&diff)[kW],
                                                int base_log, int levels,
                                                int bits, uint64_t mask,
                                                Emit emit) {
  // closest_representable: round to a multiple of q / B^levels
  const int non_rep = bits - base_log * levels;
  const uint64_t bmask = (1ull << base_log) - 1ull;
  uint64_t state[kW];
#pragma unroll
  for (int k = 0; k < kW; ++k) {
    uint64_t res = ((diff[k] >> (non_rep - 1)) + 1ull) & ~1ull;
    res = (res << (non_rep - 1)) & mask;
    state[k] = res >> non_rep;
  }
  for (int it = 0; it < levels; ++it) {
    int32_t dg[kW];
#pragma unroll
    for (int k = 0; k < kW; ++k) {
      const uint64_t r = state[k] & bmask;
      state[k] >>= base_log;
      uint64_t carry = ((r - 1ull) | state[k]) & r;
      carry >>= (base_log - 1);
      state[k] += carry;
      dg[k] = (int32_t)r - ((int32_t)carry << base_log);
    }
    emit(levels - 1 - it, dg);
  }
}

// The signed gadget decomposition of one torus word: emit(level, digit)
// for each of the `levels` digits, level index 0 the largest.
template <typename Emit>
__device__ __forceinline__ void decompose_word(uint64_t diff, int base_log,
                                               int levels, int bits,
                                               uint64_t mask, Emit emit) {
  const uint64_t one[1] = {diff};
  decompose_words(one, base_log, levels, bits, mask,
                  [&](int lvl, const int32_t(&dg)[1]) { emit(lvl, dg[0]); });
}

// K1: diff = acc * X^ahat - acc, then the signed gadget decomposition of
// diff.  Block (x, g, z), thread (tx, ty): ciphertext b = x blockDim.y +
// ty, GLWE polynomial g, the kRotWords coefficients from j0 = (z blockDim.x
// + tx) kRotWords.  acc must be 16-byte aligned.
__global__ void rotate_decompose_kernel(const int64_t* __restrict__ acc,
                                        const int32_t* __restrict__ ahat,
                                        int32_t* __restrict__ digits, int B,
                                        int G, int N, int base_log, int levels,
                                        int bits) {
  const int b = blockIdx.x * blockDim.y + threadIdx.y;
  if (b >= B) return;
  const int g = blockIdx.y;
  const uint64_t mask = bits == 64 ? ~0ull : 0xFFFFFFFFull;
  const int a = __ldg(ahat + b) & (2 * N - 1);  // 2N is the identity
  const long long plane = (long long)G * N;     // one level's words
  const int64_t* row = acc + (long long)b * plane + (long long)g * N;
  int32_t* out = digits + (long long)b * levels * plane + (long long)g * N;
  const int j0 = (blockIdx.z * blockDim.x + threadIdx.x) * kRotWords;
  uint64_t diff[kRotWords];
  const longlong2* own = reinterpret_cast<const longlong2*>(row + j0);
#pragma unroll
  for (int h = 0; h < kRotWords / 2; ++h) {
    const longlong2 v = __ldg(own + h);
    diff[2 * h] = (uint64_t)v.x;
    diff[2 * h + 1] = (uint64_t)v.y;
  }
#pragma unroll
  for (int k = 0; k < kRotWords; ++k) {
    const int t = (j0 + k - a) & (2 * N - 1);
    uint64_t v = (uint64_t)__ldg(row + (t & (N - 1)));
    if (t >= N) v = 0ull - v;
    diff[k] = (v - diff[k]) & mask;
  }
  decompose_words(diff, base_log, levels, bits, mask,
                  [&](int lvl, const int32_t(&dg)[kRotWords]) {
                    int4* o = reinterpret_cast<int4*>(out + lvl * plane +
                                                      j0);
#pragma unroll
                    for (int h = 0; h < kRotWords / 4; ++h)
                      o[h] = make_int4(dg[4 * h], dg[4 * h + 1],
                                       dg[4 * h + 2], dg[4 * h + 3]);
                  });
}

// K6's last stage: the explicit CRT of each convolution from its P
// canonical residues (ntt_core_kernels.cuh's crt_word, the residues read
// from device memory), its planes joined as conv_0 + 2^32 conv_1, added
// to the accumulator mod 2^bits.  Block (x, o, z), thread (tx, ty):
// ciphertext b = x blockDim.y + ty, output polynomial o, the kCrtWords
// coefficients from j0 = (z blockDim.x + tx) kCrtWords.  xcrt is
// ntt.residue_crt_for: w_i = (Q/p_i)^-1 mod p_i (no N^-1: ntt_mac_prime
// already scaled the residues), so c_i = r_i w_i mod p_i is one Shoup
// product a prime.  residues, acc and out are 16-byte aligned; out may not
// alias acc.
__global__ void crt_accumulate_kernel(const uint32_t* __restrict__ residues,
                                      const int64_t* __restrict__ xcrt,
                                      const int64_t* __restrict__ acc,
                                      int64_t* __restrict__ out, int B, int O,
                                      int M, int P, int N, int bits) {
  const int b = blockIdx.x * blockDim.y + threadIdx.y;
  if (b >= B) return;
  const long long row = (long long)b * O + blockIdx.y;  // (b, o)
  const int j0 = (blockIdx.z * blockDim.x + threadIdx.x) * kCrtWords;
  uint32_t p[kMaxPrimes], w[kMaxPrimes], wsh[kMaxPrimes], t[kMaxPrimes];
  uint64_t q[kMaxPrimes];
#pragma unroll
  for (int i = 0; i < kMaxPrimes; ++i) {
    if (i < P) {
      const int64_t* c = xcrt + i * kXcrtWidth;
      p[i] = (uint32_t)__ldg(c);
      w[i] = (uint32_t)__ldg(c + 1);
      wsh[i] = (uint32_t)__ldg(c + 2);
      q[i] = (uint64_t)__ldg(c + 3);
      t[i] = (uint32_t)__ldg(c + 4);
    }
  }
  const uint64_t Q = (uint64_t)__ldg(xcrt + 5);
  uint64_t total[kCrtWords];
  const longlong2* in = reinterpret_cast<const longlong2*>(acc + row * N + j0);
#pragma unroll
  for (int h = 0; h < kCrtWords / 2; ++h) {
    const longlong2 v = __ldg(in + h);
    total[2 * h] = (uint64_t)v.x;
    total[2 * h + 1] = (uint64_t)v.y;
  }
  for (int m = 0; m < M; ++m) {
    const uint32_t* r = residues + (row * M + m) * P * N + j0;
    uint64_t sum[kCrtWords];
    uint32_t frac[kCrtWords];
#pragma unroll
    for (int k = 0; k < kCrtWords; ++k) {
      sum[k] = 0;
      frac[k] = 0;
    }
#pragma unroll
    for (int i = 0; i < kMaxPrimes; ++i) {
      if (i < P) {
        const uint4 v =
            __ldg(reinterpret_cast<const uint4*>(r + (long long)i * N));
        const uint32_t rv[kCrtWords] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int k = 0; k < kCrtWords; ++k) {
          const uint32_t c = mul_shoup(rv[k], w[i], wsh[i], p[i]);
          sum[k] += (uint64_t)c * q[i];
          frac[k] += c * t[i];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kCrtWords; ++k) {
      const uint64_t kq = (frac[k] + (1u << (kFracBits - 1))) >> kFracBits;
      total[k] += (sum[k] - kq * Q) << (32 * m);
    }
  }
  const uint64_t mask = bits == 64 ? ~0ull : 0xFFFFFFFFull;
  longlong2* o = reinterpret_cast<longlong2*>(out + row * N + j0);
#pragma unroll
  for (int h = 0; h < kCrtWords / 2; ++h)
    o[h] = make_longlong2((long long)(total[2 * h] & mask),
                          (long long)(total[2 * h + 1] & mask));
}

}  // namespace tfhe_pbs
