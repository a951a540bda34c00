// Blind-rotation step kernels for Hopper (sm_90a) on the shared-memory NTT
// core, and the device functions the other kernels share:
//
//   rotate_decompose_kernel  <- rot_kernel (:1229) -> _rot_dec_limbs (:614)
//                               of `tfhe_tpu/ops/fused_pbs.py:1213`
//                               (`fused_blind_rotate_scan2`), K1
//   crt_accumulate_kernel    <- crt_kernel (:1520) -> _crt_accumulate (:709),
//                               K6's last stage
//   ntt_mac_kernel           <- K8's mac_kernel (multibit_kernels.cuh)
//
// Each is a template on one flag.  The classic schedules instantiate
// rotate_decompose_kernel<true> and crt_accumulate_kernel<true>; the
// multi-bit step (`multibit_kernels.cuh`) rotate_decompose_kernel<false>,
// ntt_mac_kernel<true> and crt_accumulate_kernel<false>: the decomposition
// of the accumulator itself with no rotation, a key per ciphertext instead
// of one shared key, and a CRT that starts from zero because the multi-bit
// external product replaces the accumulator.  The classic per-prime stage
// (ntt_mac_kernel<false>, K2's and K6's first port) moved to the
// register-resident core of ntt_core.cuh.
//
// Integer arithmetic only; every result is bit-exact.  Layouts (all dense):
//   acc       [B, G, N]          int64  u64 torus words (u32: in [0, 2^32))
//   ahat      [B]                int32  modulus-switched mask element, [0, 2N]
//   digits    [B, L, G, N]       int32  signed gadget digits, level-major
//   kspec     [P, LJ, O, M, N]   uint32 one step's key spectra, canonical mod p
//   kshoup    [P, LJ, O, M, N]   uint32 their Shoup companions
//   tables    [P, 5, N]          uint32 psi^bitrev, companion, psi^-bitrev,
//                                       companion, (N^-1, companion, p,
//                                       floor(2^34 / p), 0...)
//   crt       [P, 2P + 4]        int64  Garner constants (see ops/ntt.py)
//   residues  [B, O, M, P, N]    uint32 per-prime convolutions, canonical
// with LJ = L*G digit polynomials, O = G output polynomials, M key planes
// (two 32-bit planes of a u64 key word, one for a u32 word) and P primes.
//
// What bounds them on the card: rotate_decompose moves 8 bytes in and
// 4*L bytes out per coefficient and is bound by memory.  ntt_mac does
// (LJ + O*M) NTTs of N points per (ciphertext, prime), 32-bit Shoup
// products throughout; it runs far above its integer-issue bound, its time
// going to barrier and load latency (a shared round trip and two twiddle
// loads a butterfly, a barrier a stage: PERF.md section 6); K2, K4 and K6
// moved to the register-resident core of ntt_core.cuh.  It keeps every
// transform in shared memory, so device memory sees only the digits, the
// step's key spectra (shared by all ciphertexts, so mostly from L2) and the
// residues.  crt_accumulate reads the residues and the accumulator once and
// writes the accumulator once.
#pragma once

#include <stdint.h>

namespace tfhe_pbs {

constexpr int kMaxPrimes = 8;
// the explicit CRT's constants per prime (ntt._explicit_crt_host): p, w,
// w's Shoup companion, Q/p mod 2^64, round(2^kFracBits / p), Q mod 2^64
constexpr int kXcrtWidth = 6;
constexpr int kFracBits = 28;

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

// a * b mod p for a, b < p < 2^17, with mu = floor(2^34 / p): x = a * b
// < 2^34 and x * mu < 2^55, and q = floor(x * mu / 2^34) > x / p - 2, so
// x - q * p lies in [0, 2p) and one subtraction lands it.  For products of
// two operands that vary per ciphertext, where no Shoup companion exists.
__device__ __forceinline__ uint32_t mul_mod(uint32_t a, uint32_t b,
                                            uint32_t p, uint32_t mu) {
  const uint64_t x = (uint64_t)a * b;
  const uint64_t q = (x * mu) >> 34;
  const uint32_t r = (uint32_t)(x - q * p);
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

// The signed gadget decomposition of one torus word
// (tfhe_tpu/ops/decomposition.py:24-87): emit(level, digit) for each of the
// `levels` digits, level index 0 the largest.
template <typename Emit>
__device__ __forceinline__ void decompose_word(uint64_t diff, int base_log,
                                               int levels, int bits,
                                               uint64_t mask, Emit emit) {
  // closest_representable: round to a multiple of q / B^levels
  const int non_rep = bits - base_log * levels;
  uint64_t res = ((diff >> (non_rep - 1)) + 1ull) & ~1ull;
  res = (res << (non_rep - 1)) & mask;
  uint64_t state = res >> non_rep;
  const uint64_t bmask = (1ull << base_log) - 1ull;
  for (int k = 0; k < levels; ++k) {
    const uint64_t r = state & bmask;
    state >>= base_log;
    uint64_t carry = ((r - 1ull) | state) & r;
    carry >>= (base_log - 1);
    state += carry;
    // digits come out smallest weight first
    emit(levels - 1 - k, (int32_t)r - ((int32_t)carry << base_log));
  }
}

// K1 (kRotate): rotated = acc * X^ahat, diff = rotated - acc, then the
// signed gadget decomposition of diff.  Without kRotate, the decomposition
// of acc itself (the multi-bit step, tfhe_tpu/ops/fused_multibit.py:264
// _dec_limbs); ahat is not read.  One thread per (ciphertext, GLWE
// polynomial, coefficient).
template <bool kRotate>
__global__ void rotate_decompose_kernel(const int64_t* __restrict__ acc,
                                        const int32_t* __restrict__ ahat,
                                        int32_t* __restrict__ digits, int B,
                                        int G, int N, int base_log, int levels,
                                        int bits) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * G * N) return;
  const int j = (int)(idx % N);
  const int g = (int)((idx / N) % G);
  const int b = (int)(idx / ((long long)N * G));
  const uint64_t mask = bits == 64 ? ~0ull : 0xFFFFFFFFull;

  uint64_t diff;
  if constexpr (kRotate) {
    // a == 2N is the identity
    diff = rotated_diff(acc + ((long long)b * G + g) * N,
                        ahat[b] & (2 * N - 1), j, N, mask);
  } else {
    diff = (uint64_t)acc[idx] & mask;
  }
  decompose_word(diff, base_log, levels, bits, mask,
                 [&](int lvl, int32_t digit) {
                   digits[(((long long)b * levels + lvl) * G + g) * N + j] =
                       digit;
                 });
}

// Forward negacyclic NTT of `count` polynomials held in shared memory:
// Cooley-Tukey butterflies with psi^bitrev twiddles (ops/ntt.py forward_ntt).
__device__ __forceinline__ void ntt_forward_smem(uint32_t* a, int count,
                                                 int N, int log_n,
                                                 const uint32_t* psi,
                                                 const uint32_t* psi_sh,
                                                 uint32_t p) {
  const int half = N >> 1;
  for (int m = 1, log_t = log_n - 1; m < N; m <<= 1, --log_t) {
    const int t = 1 << log_t;
    for (int idx = threadIdx.x; idx < count * half; idx += blockDim.x) {
      const int poly = idx >> (log_n - 1);
      const int bf = idx & (half - 1);
      const int i = bf >> log_t;
      const int jj = (i << (log_t + 1)) + (bf & (t - 1));
      uint32_t* x = a + poly * N;
      const uint32_t u = x[jj];
      const uint32_t v = mul_shoup(x[jj + t], psi[m + i], psi_sh[m + i], p);
      x[jj] = add_mod(u, v, p);
      x[jj + t] = sub_mod(u, v, p);
    }
    __syncthreads();
  }
}

// Inverse: Gentleman-Sande butterflies with psi^-bitrev twiddles, without
// the final N^-1 scale (ops/ntt.py inverse_ntt).
__device__ __forceinline__ void ntt_inverse_smem(uint32_t* a, int count,
                                                 int N, int log_n,
                                                 const uint32_t* psi_inv,
                                                 const uint32_t* psi_inv_sh,
                                                 uint32_t p) {
  const int half = N >> 1;
  for (int h = N >> 1, log_t = 0; h >= 1; h >>= 1, ++log_t) {
    const int t = 1 << log_t;
    for (int idx = threadIdx.x; idx < count * half; idx += blockDim.x) {
      const int poly = idx >> (log_n - 1);
      const int bf = idx & (half - 1);
      const int i = bf >> log_t;
      const int jj = (i << (log_t + 1)) + (bf & (t - 1));
      uint32_t* x = a + poly * N;
      const uint32_t u = x[jj];
      const uint32_t v = x[jj + t];
      x[jj] = add_mod(u, v, p);
      x[jj + t] = mul_shoup(sub_mod(u, v, p), psi_inv[h + i],
                            psi_inv_sh[h + i], p);
    }
    __syncthreads();
  }
}

// One prime's external product of one ciphertext, in shared memory: dsp
// [LJ, N] holds the digits mod p (written and synchronised by the caller)
// and is transformed in place; on return osp [O*M, N] holds the inverse
// transforms of sum_lj dsp_lj * key_lj, not yet scaled by N^-1.  ks (and ksh)
// point at this prime's key block [LJ, O*M, N]; with kKeyPerCiphertext the
// key varies per ciphertext (the multi-bit combined key), its products are
// Barrett products and ksh is not read.
template <bool kKeyPerCiphertext>
__device__ __forceinline__ void ntt_mac_smem(uint32_t* dsp, uint32_t* osp,
                                             const uint32_t* ks,
                                             const uint32_t* ksh,
                                             const uint32_t* tab, int LJ,
                                             int OM, int N, int log_n) {
  const uint32_t p = tab[4 * N + 2];
  const uint32_t mu = tab[4 * N + 3];
  ntt_forward_smem(dsp, LJ, N, log_n, tab, tab + N, p);
  for (int idx = threadIdx.x; idx < OM * N; idx += blockDim.x) {
    const int n = idx & (N - 1);
    uint32_t s = 0;
    for (int lj = 0; lj < LJ; ++lj) {
      const long long k = (long long)lj * OM * N + idx;
      if constexpr (kKeyPerCiphertext) {
        s = add_mod(s, mul_mod(dsp[lj * N + n], ks[k], p, mu), p);
      } else {
        s = add_mod(s, mul_shoup(dsp[lj * N + n], ks[k], ksh[k], p), p);
      }
    }
    osp[idx] = s;
  }
  __syncthreads();
  ntt_inverse_smem(osp, OM, N, log_n, tab + 2 * N, tab + 3 * N, p);
}

// K8's external product (kKeyPerCiphertext; the <false> form, K2's and K6's
// first port, is launched by nothing now): one block per (ciphertext,
// prime).  Digits mod p -> forward NTT -> spectrum multiply-accumulate
// against the step's key -> inverse NTT -> per-prime residues of the O*M
// convolutions.  The block's prime is prime0 + blockIdx.y of P; kspec (and
// kshoup) start at prime prime0's block, [gridDim.y, LJ, O, M, N], or with
// kKeyPerCiphertext are the whole [B, P, LJ, O, M, N].
template <bool kKeyPerCiphertext>
__global__ void ntt_mac_kernel(const int32_t* __restrict__ digits,
                               const uint32_t* __restrict__ kspec,
                               const uint32_t* __restrict__ kshoup,
                               const uint32_t* __restrict__ tables,
                               uint32_t* __restrict__ residues, int LJ, int O,
                               int M, int N, int log_n, int prime0, int P) {
  extern __shared__ uint32_t smem[];
  const int b = blockIdx.x;
  const int pi = prime0 + blockIdx.y;
  const int OM = O * M;
  const uint32_t* tab = tables + (long long)pi * 5 * N;
  const uint32_t ninv = tab[4 * N];
  const uint32_t ninv_sh = tab[4 * N + 1];
  const uint32_t p = tab[4 * N + 2];
  uint32_t* dsp = smem;           // [LJ, N] digit spectra
  uint32_t* osp = smem + LJ * N;  // [O*M, N] output spectra

  const int32_t* dig = digits + (long long)b * LJ * N;
  for (int idx = threadIdx.x; idx < LJ * N; idx += blockDim.x) {
    int32_t r = dig[idx] % (int32_t)p;
    dsp[idx] = (uint32_t)(r < 0 ? r + (int32_t)p : r);
  }
  __syncthreads();

  const long long kstride = (long long)LJ * OM * N;
  const long long kblock =
      kKeyPerCiphertext ? (long long)b * P + pi : blockIdx.y;
  ntt_mac_smem<kKeyPerCiphertext>(
      dsp, osp, kspec + kblock * kstride,
      kKeyPerCiphertext ? nullptr : kshoup + kblock * kstride, tab, LJ, OM, N,
      log_n);

  for (int idx = threadIdx.x; idx < OM * N; idx += blockDim.x) {
    const int n = idx & (N - 1);
    const int om = idx >> log_n;
    residues[(((long long)b * OM + om) * P + pi) * N + n] =
        mul_shoup(osp[idx], ninv, ninv_sh, p);
  }
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

// K6's last stage and K8's CRT: Garner's reconstruction of each
// convolution, its planes recombined as conv_0 + 2^32 conv_1, added to the
// accumulator mod 2^64 (kAccumulate) or written as the new accumulator (the
// multi-bit step; acc is not read).  One thread per (ciphertext, output
// polynomial, coefficient).
template <bool kAccumulate>
__global__ void crt_accumulate_kernel(const uint32_t* __restrict__ residues,
                                      const int64_t* __restrict__ crt,
                                      const int64_t* __restrict__ acc,
                                      int64_t* __restrict__ out, int B, int O,
                                      int M, int P, int N, int bits) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * O * N) return;
  const int n = (int)(idx % N);
  const long long bo = idx / N;  // b * O + o
  uint64_t total = kAccumulate ? (uint64_t)acc[idx] : 0ull;
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
