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
//   crt       [P, 2P + 4]        int64  Garner constants (see ops/ntt.py)
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

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b,
                                            uint32_t p) {
  uint32_t s = a + b;
  return s >= p ? s - p : s;
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b,
                                            uint32_t p) {
  return a >= b ? a - b : a + p - b;
}

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

// Balanced Garner reconstruction of one convolution coefficient from its P
// canonical residues, residue(i) for prime i: the unique integer in
// (-Q/2, Q/2), Q = prod p, with those residues, as a word mod 2^64.
template <typename Residue>
__device__ __forceinline__ uint64_t garner(Residue residue,
                                           const int64_t* __restrict__ crt,
                                           int P) {
  const int W = 2 * P + 4;  // row width of the Garner table
  int32_t bs[kMaxPrimes];
  uint64_t x = 0;
  for (int i = 0; i < P; ++i) {
    const int64_t* row = crt + (long long)i * W;
    const uint32_t p = (uint32_t)row[2 * P + 2];
    uint32_t partial = 0;
    for (int j = 0; j < i; ++j) {
      // |b_j| < p_j / 2 < p_i (primes ascend), so one add canonicalizes
      const uint32_t bj = (uint32_t)(bs[j] < 0 ? bs[j] + (int32_t)p : bs[j]);
      partial = add_mod(partial,
                        mul_shoup(bj, (uint32_t)row[j], (uint32_t)row[P + j],
                                  p),
                        p);
    }
    uint32_t d = sub_mod(residue(i), partial, p);
    d = mul_shoup(d, (uint32_t)row[2 * P], (uint32_t)row[2 * P + 1], p);
    bs[i] = d > p / 2 ? (int32_t)d - (int32_t)p : (int32_t)d;
    x += (uint64_t)(int64_t)bs[i] * (uint64_t)row[2 * P + 3];
  }
  return x;
}

// K6's last stage: Garner's reconstruction of each convolution, its planes
// recombined as conv_0 + 2^32 conv_1, added to the accumulator mod 2^64.
// One thread per (ciphertext, output polynomial, coefficient).
__global__ void crt_accumulate_kernel(const uint32_t* __restrict__ residues,
                                      const int64_t* __restrict__ crt,
                                      const int64_t* __restrict__ acc,
                                      int64_t* __restrict__ out, int B, int O,
                                      int M, int P, int N, int bits) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * O * N) return;
  const int n = (int)(idx % N);
  const long long bo = idx / N;  // b * O + o
  uint64_t total = (uint64_t)acc[idx];
  for (int m = 0; m < M; ++m) {
    const uint32_t* r = residues + ((bo * M + m) * P) * N + n;
    const uint64_t x =
        garner([&](int i) { return r[(long long)i * N]; }, crt, P);
    total += m == 0 ? x : (x << 32);
  }
  if (bits == 32) total &= 0xFFFFFFFFull;
  out[idx] = (int64_t)total;
}

}  // namespace tfhe_pbs
