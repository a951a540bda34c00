// The Shoup spectrum multiply-accumulate for Hopper (sm_90a): the port's
// counterpart of K10, `shoup_mac` -> `_shoup_mac_kernel`
// (tfhe_tpu/ops/pallas_kernels.py:64, :39), the middle stage of the CRT-NTT
// external product (tfhe_tpu/ops/polymul_ntt.py:104-123), for the P primes
// of a step in one launch (P = 1: the reference's per-prime call).
//
//   a    [P, B, LJ, N]   int32  balanced digit spectra, |a| <= (p-1)/2
//   ks   [P, LJ, GM, N]  int32  balanced key spectra of one step
//   ksh  [P, LJ, GM, N]  int32  their Shoup companions round(ks * 2^16 / p)
//   out  [B, GM, P, N]   int32  sum_j a[i, b, j] * ks[i, j, gm] mod p_i,
//                               balanced: the layout the inverse NTT reads
//
// The arithmetic is the Pallas body's, word for word: q = (a * ksh) >> 16
// (arithmetic shift), r = a * ks - q * p, two corrections on each side, an
// int32 sum over LJ, then one centring acc - rint(acc / p) * p.  No signed
// overflow: |a * ksh| <= 43008 * 2^15 < 2^31, |a * ks| <= 43008^2 < 2^31.
// The centring divides in float with IEEE rounding (__fdiv_rn, no fast
// math) and rounds half to even (__float2int_rn), as jnp.round does:
// |acc| < 2^24 is exact in float, |acc / p| <= LJ / 2 < 8, and the float
// quotient's error (half an ulp, at most 2^-22 below 8) is below 1 / (2p),
// the least distance of acc / p from a half-integer (2 acc - (2m + 1) p is
// odd), so it never rounds across a half.
//
// First design: one launch per prime, one thread per output word, (b, gm,
// n) recovered with 64-bit `/` and `%`, each digit word loaded again for
// every one of the GM output rows, 4-byte loads, the outputs stacked into
// [B, GM, P, N] by a copy afterwards; 6x its byte bound at shortint width.
// Now: a thread owns kVec = 4 consecutive coefficients of one (prime,
// ciphertext); it loads its LJ digit vectors once (16-byte loads) and
// keeps them in registers through all GM output rows, reading each key
// vector and its companions with 16-byte loads.  A block is 32 x kRows
// threads: a warp covers 128 coefficients of one ciphertext (512
// contiguous bytes a load), and the kRows warps of a block take kRows
// ciphertexts at the same coefficients, so each key vector comes from
// device memory (or L2) once a block and from L1 for the other warps.
// grid.x = ceil(B / kRows) * ceil(N / 128) carries the batch (it takes up
// to 2^31 - 1 blocks), grid.y the prime; index arithmetic is 32-bit but
// for each thread's three base offsets.
//
// What bounds it: (P B LJ N + 2 P LJ GM N + P B GM N) * 4 bytes read once
// and written once, with ~15 operations per term: bound by bytes.  On an
// H100, a step of five primes at B = 64: 0.0082 ms at shortint width (LJ
// 2, GM 4, N 2048; 1.7x its bound), from 0.0360 in five launches and a
// stack; 0.0144 at u128 width (1.8x); 0.0110 at boolean width (LJ 9, GM
// 3, N 512; 4.4x: its 160 blocks leave 10 warps an SM, too few to hide
// the loads' latency).
#pragma once

#include <stdint.h>

namespace tfhe_shoup {

constexpr int kMaxPrimes = 8;
constexpr int kMaxLJ = 15;  // keeps |acc / p| < 8 (the centring above)
constexpr int kVec = 4;     // coefficients a thread owns
constexpr int kWarpWords = 32 * kVec;
constexpr int kRows = 8;    // ciphertexts a block takes

struct Primes {
  int p[kMaxPrimes];
};

__device__ __forceinline__ int shoup_term(int a, int k, int h, int p,
                                          int half) {
  const int q = (a * h) >> 16;
  int r = a * k - q * p;
  if (r > half) r -= p;
  if (r > half) r -= p;
  if (r < -half) r += p;
  if (r < -half) r += p;
  return r;
}

__device__ __forceinline__ int centre(int acc, int p) {
  return acc - __float2int_rn(__fdiv_rn((float)acc, (float)p)) * p;
}

// LJ <= LJ_MAX digit vectors held in registers
template <int LJ_MAX>
__global__ void __launch_bounds__(32 * kRows)
    shoup_mac_kernel(const int32_t* __restrict__ a,
                     const int32_t* __restrict__ ks,
                     const int32_t* __restrict__ ksh,
                     int32_t* __restrict__ out, Primes primes, int B, int LJ,
                     int GM, int N, int P) {
  const int tiles = (N + kWarpWords - 1) / kWarpWords;
  const int tile = blockIdx.x % tiles;
  const int b = blockIdx.x / tiles * kRows + threadIdx.y;
  const int n = (tile * 32 + threadIdx.x) * kVec;
  if (b >= B || n >= N) return;
  const int pi = blockIdx.y;
  const int p = primes.p[pi];
  const int half = p / 2;
  const int32_t* ap = a + ((long long)pi * B + b) * LJ * N + n;
  const int32_t* kp = ks + (long long)pi * LJ * GM * N + n;
  const int32_t* hp = ksh + (long long)pi * LJ * GM * N + n;
  int32_t* op = out + ((long long)b * GM * P + pi) * N + n;
  int4 d[LJ_MAX];
#pragma unroll
  for (int j = 0; j < LJ_MAX; ++j)
    if (j < LJ) d[j] = __ldg(reinterpret_cast<const int4*>(ap + j * N));
  for (int gm = 0; gm < GM; ++gm) {
    int s0 = 0, s1 = 0, s2 = 0, s3 = 0;
#pragma unroll
    for (int j = 0; j < LJ_MAX; ++j) {
      if (j < LJ) {
        const int at = (j * GM + gm) * N;
        const int4 k = __ldg(reinterpret_cast<const int4*>(kp + at));
        const int4 h = __ldg(reinterpret_cast<const int4*>(hp + at));
        s0 += shoup_term(d[j].x, k.x, h.x, p, half);
        s1 += shoup_term(d[j].y, k.y, h.y, p, half);
        s2 += shoup_term(d[j].z, k.z, h.z, p, half);
        s3 += shoup_term(d[j].w, k.w, h.w, p, half);
      }
    }
    *reinterpret_cast<int4*>(op + gm * P * N) = make_int4(
        centre(s0, p), centre(s1, p), centre(s2, p), centre(s3, p));
  }
}

}  // namespace tfhe_shoup
