// The Shoup spectrum multiply-accumulate for Hopper (sm_90a): the port's
// counterpart of K10, `shoup_mac` -> `_shoup_mac_kernel`
// (tfhe_tpu/ops/pallas_kernels.py:64, :39), the middle stage of the CRT-NTT
// external product (tfhe_tpu/ops/polymul_ntt.py:104-123) for one prime p.
//
//   a    [B, LJ, N]   int32  balanced digit spectra, |a| <= (p-1)/2
//   ks   [LJ, GM, N]  int32  balanced key spectra of one step and prime
//   ksh  [LJ, GM, N]  int32  their Shoup companions round(ks * 2^16 / p)
//   out  [B, GM, N]   int32  sum_j a[b, j] * ks[j, gm] mod p, balanced
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
// Layout: one thread per output word (b, gm, n), n fastest, so the loads of
// a[b, j, n], ks[j, gm, n] and ksh[j, gm, n] coalesce; the thread loops
// over j < LJ.  The grid is one-dimensional with a 64-bit index, so any
// batch fits (grid.x takes up to 2^31 - 1 blocks).
//
// What bounds it: each output word reads LJ digit words (shared by the GM
// outputs of its ciphertext, so mostly from L1/L2) and 2 * LJ key words
// (shared by the batch) and writes one word: at the main paths' shapes the
// card needs (B*LJ*N + 2*LJ*GM*N + B*GM*N) * 4 bytes, a microsecond at
// 3.35 TB/s.  The kernel is elementwise and bound by bytes; at these sizes
// its launch, not its work, sets its time.
#pragma once

#include <stdint.h>

namespace tfhe_shoup {

__global__ void shoup_mac_kernel(const int32_t* __restrict__ a,
                                 const int32_t* __restrict__ ks,
                                 const int32_t* __restrict__ ksh,
                                 int32_t* __restrict__ out, long long total,
                                 int LJ, int GM, int N, int p) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int n = (int)(idx % N);
  const long long rest = idx / N;
  const int gm = (int)(rest % GM);
  const long long b = rest / GM;
  const int half = p / 2;
  const int32_t* ap = a + b * LJ * N + n;
  const int32_t* kp = ks + (long long)gm * N + n;
  const int32_t* hp = ksh + (long long)gm * N + n;
  const long long kstride = (long long)GM * N;
  int acc = 0;
  for (int j = 0; j < LJ; ++j) {
    const int aj = ap[(long long)j * N];
    const int q = (aj * hp[j * kstride]) >> 16;
    int r = aj * kp[j * kstride] - q * p;
    if (r > half) r -= p;
    if (r > half) r -= p;
    if (r < -half) r += p;
    if (r < -half) r += p;
    acc += r;
  }
  const int k = __float2int_rn(__fdiv_rn((float)acc, (float)p));
  out[idx] = acc - k * p;
}

}  // namespace tfhe_shoup
