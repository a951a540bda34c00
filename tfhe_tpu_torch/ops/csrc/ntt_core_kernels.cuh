// K2 and K7 on the register-resident NTT core (ntt_core.cuh), for Hopper
// (sm_90a):
//
//   external_product_cluster_kernel   <- fused_blind_rotate_scan2 (:1213)
//                                        -> pc_kernel (:1244)
//                                        -> _primes_crt_math (:1069)  (K2)
//   blind_rotate_core_kernel,         <- fused_blind_rotate_planes (:1545)
//   blind_rotate_cluster_core_kernel     -> _make_kernel (:1403)
//                                        -> _step_math (:755)         (K7)
// (lines of tfhe_tpu/ops/fused_pbs.py).  Layouts are those of
// pbs_kernels.cuh and single_cta_kernels.cuh; `tables` is
// ntt.pass_tables_for(N) [P, kHeader + 2 W], `xcrt` the explicit CRT's
// constants [P, 6] (ntt._explicit_crt_host).  All take LJ = L*G <= 9
// (every parameter set of the catalog) and 256 <= N <= 2048; their
// launchers refuse anything else.  Registers from `nvcc -Xptxas -v` (sm_90a,
// CUDA 12.8), none spilled, for LJ <= 2 / 4 / 9: external_product_cluster
// 80 / 110 / 152, blind_rotate_core 102 / 120 / 162, blind_rotate_cluster_
// core 128 / 182 / 226.
//
// K2, first design: one CTA of 512 threads per (ciphertext, prime)
// on the shared-memory core, 22 stage barriers and 48 KB at
// PARAM_MESSAGE_2_CARRY_2_KS_PBS (LJ 2, OM 4, N 2048), key words as scalar
// loads, digits reduced with `int32 % p`, and a second launch for Garner's
// CRT over residues that made a round trip through device memory (10.5 MB
// each way a step at B = 64); 0.0917 ms a step at B = 64 on an H100, 20x
// its bound by operations, the time going to barrier and load latency.
// New: a cluster of P CTAs of N/8 threads per ciphertext, one prime each,
// 6 barriers and 32 KB (max(LJ, OM) polynomials) a CTA, the MAC in
// registers on 16-byte key loads, and the explicit CRT in the same launch
// over the CTAs' shared memory: one launch a step, no residues in device
// memory.  Every CTA of a prime still reads that prime's whole key slice
// (128 KB, from L2).  On an H100: 0.0280 ms a step at B = 64 (3.3x
// faster), 6.3x its bound; what binds it now is latency, hidden only by
// the other CTAs of the SM (3 of them at 80 registers).
//
// K7, first design: one CTA of 512 threads per ciphertext for all n
// steps, each output polynomial through its own shared-memory transform,
// about 327 (shortint) and 222 (boolean) barriers a step; 166 and 142 ms a
// rotation at B = 64, 49x and 100x its bound.  New: two kernels, the
// launcher picking one from B and the SMs the device has
// (single_cta_kernels.cu):
//   - blind_rotate_core_kernel: one CTA of N/8 threads per ciphertext, the
//     primes in turn, the accumulator [G, N] u64 and the explicit CRT's
//     fractions [OM, N] u32 in shared memory throughout.  A thread owns the
//     same positions tid + k N/8 in the digits, in every prime's last
//     inverse pass and in the accumulator, so it writes and reads the
//     digits, and adds the CRT's running sums, with no barrier: 2 (passes -
//     1) barriers a prime and one a step (31 at N = 2048, 21 at N = 512).
//     Shared memory G N 8 + OM N 4 + LJ N 4 + max(LJ, OM) N 4 bytes: 112 KB
//     at PARAM_MESSAGE_2_CARRY_2_KS_PBS (two CTAs an SM), 54 KB at boolean
//     DEFAULT_PARAMETERS;
//   - blind_rotate_cluster_core_kernel: a cluster of P CTAs per
//     ciphertext, one prime each, every CTA holding the accumulator, which
//     the explicit CRT rewrites in all of them once a step through
//     distributed shared memory (two cluster barriers a step).  It uses the
//     SMs a batch of fewer ciphertexts than SMs leaves idle.
// On an H100 at B = 64: 34.6 ms (shortint, 742 steps) and 20.8 ms
// (boolean, 722 steps) a rotation, both in the cluster form, 10x and 15x
// the bound; latency of the key and twiddle loads binds, as in K2.
#pragma once

#include <cooperative_groups.h>
#include <stdint.h>

#include "ntt_core.cuh"
#include "pbs_kernels.cuh"

namespace tfhe_core {

namespace cg = cooperative_groups;

constexpr int kMaxDigitPolys = 9;

// The explicit CRT's constants of every prime (ntt._explicit_crt_host):
// Q/p_i mod 2^64, round(2^28 / p_i), Q mod 2^64.
struct Xcrt {
  uint64_t q[tfhe_pbs::kMaxPrimes];
  uint32_t t[tfhe_pbs::kMaxPrimes];
  uint64_t Q;
};

__device__ __forceinline__ Xcrt load_xcrt(const int64_t* __restrict__ xcrt,
                                          int P) {
  Xcrt x;
#pragma unroll
  for (int i = 0; i < tfhe_pbs::kMaxPrimes; ++i) {
    x.q[i] = i < P ? (uint64_t)xcrt[i * tfhe_pbs::kXcrtWidth + 3] : 0;
    x.t[i] = i < P ? (uint32_t)xcrt[i * tfhe_pbs::kXcrtWidth + 4] : 0;
  }
  x.Q = (uint64_t)xcrt[5];
  return x;
}

// total + the word (o, n) of the product, from the P primes' values
// c_i = r_i N^-1 (Q/p_i)^-1 mod p_i, cs[i] pointing at prime i's [OM, N]
// (swizzled) in its CTA's shared memory: per plane m, sum_i c_i Q/p_i minus
// round(sum_i c_i t_i / 2^28) Q, shifted by 32 m bits, all mod 2^64.  The
// same words as single_cta_kernels.cuh's running sums and correction.
__device__ __forceinline__ uint64_t crt_word(const uint32_t* const* cs,
                                             const Xcrt& x, int P, int o,
                                             int M, int N, int n,
                                             uint64_t total) {
  for (int m = 0; m < M; ++m) {
    const int at = (o * M + m) * N + swz(n);
    uint64_t sum = 0;
    uint32_t frac = 0;
#pragma unroll
    for (int i = 0; i < tfhe_pbs::kMaxPrimes; ++i) {
      if (i < P) {
        const uint32_t c = cs[i][at];
        sum += (uint64_t)c * x.q[i];
        frac += c * x.t[i];
      }
    }
    const uint64_t k = (frac + (1u << (tfhe_pbs::kFracBits - 1))) >>
                       tfhe_pbs::kFracBits;
    total += (sum - k * x.Q) << (32 * m);
  }
  return total;
}

// CTAs of 256 threads an SM should hold (the launch bounds' minimum, which
// caps the registers a thread takes); the digit spectra alone take
// LJ_MAX * 8 registers
template <int LJ_MAX>
constexpr int min_ctas() {
  return LJ_MAX <= 2 ? 3 : (LJ_MAX <= 4 ? 2 : 1);
}

// K2 in one launch: a cluster of P CTAs per ciphertext, CTA rank i running
// prime i (grid B * P, N/8 threads).  Each CTA leaves its prime's values
// c_i at its own words of buf; after a cluster barrier each takes 1/P of
// the G*N output words and runs the explicit CRT over the P CTAs' values,
// read through distributed shared memory: out = acc + the product.
template <int LJ_MAX>
__global__ void __launch_bounds__(256, min_ctas<LJ_MAX>())
    external_product_cluster_kernel(const int32_t* __restrict__ digits,
                                    const uint32_t* __restrict__ kspec,
                                    const uint32_t* __restrict__ kshoup,
                                    const uint32_t* __restrict__ tables,
                                    const int64_t* __restrict__ xcrt,
                                    const int64_t* __restrict__ acc,
                                    int64_t* __restrict__ out, int LJ, int G,
                                    int M, int N, int log_n, int bits) {
  extern __shared__ uint4 core_smem[];
  uint32_t* buf = reinterpret_cast<uint32_t*>(core_smem);
  cg::cluster_group cluster = cg::this_cluster();
  const int P = (int)cluster.num_blocks();
  const int pi = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const long long b = blockIdx.x / P;
  const int OM = G * M;
  const Plan pl = make_plan(log_n);
  const uint32_t* tab = tables + (long long)pi * (kHeader + 2 * pl.words);
  const int stride = N >> kLogRadix;
  const int32_t* dig = digits + b * LJ * N + tid;
  const long long kblock = (long long)LJ * OM * N;
  const int64_t* row = xcrt + pi * tfhe_pbs::kXcrtWidth;
  const uint32_t p = (uint32_t)row[0];
  const uint32_t w = (uint32_t)row[1];
  const uint32_t wsh = (uint32_t)row[2];
  external_product_prime<LJ_MAX>(
      buf, LJ, OM, N, pl, tab, kspec + pi * kblock, kshoup + pi * kblock,
      [&](int lj, int k) { return dig[lj * N + k * stride]; },
      [&](int om, int k, uint32_t x) {
        buf[om * N + swz(tid + k * stride)] = shoup_canonical(x, w, wsh, p);
      });
  cluster.sync();  // every prime's values are in its CTA's buf

  const uint32_t* cs[tfhe_pbs::kMaxPrimes];
#pragma unroll
  for (int i = 0; i < tfhe_pbs::kMaxPrimes; ++i)
    cs[i] = i < P ? cluster.map_shared_rank(buf, i) : buf;
  const Xcrt x = load_xcrt(xcrt, P);
  const uint64_t mask = bits == 64 ? ~0ull : 0xFFFFFFFFull;
  const int share = (G * N + P - 1) / P;
  const int end = min(G * N, (pi + 1) * share);
  for (int idx = pi * share + tid; idx < end; idx += blockDim.x)
    out[b * G * N + idx] = (int64_t)(
        crt_word(cs, x, P, idx >> log_n, M, N, idx & (N - 1),
                 (uint64_t)acc[b * G * N + idx]) & mask);
  cluster.sync();  // no CTA leaves while another reads its buf
}

// K7 split over a cluster of P CTAs per ciphertext, CTA rank i running
// prime i of every step (grid B * P, N/8 threads); every CTA keeps the
// whole accumulator.  A step: the digits, prime i's external product (its
// values c_i at this thread's words of buf), a cluster barrier, the
// explicit CRT over this CTA's 1/P of the words, written into every CTA's
// accumulator through distributed shared memory, a cluster barrier.  The
// launcher picks it over blind_rotate_core_kernel when the batch leaves
// SMs idle (single_cta_kernels.cu).  Shared memory: G N 8 + LJ N 4 +
// max(LJ, OM) N 4 bytes.
template <int LJ_MAX>
__global__ void __launch_bounds__(256, min_ctas<LJ_MAX>() > 2 ? 2 : 1)
    blind_rotate_cluster_core_kernel(const int64_t* __restrict__ acc_in,
                                     const int32_t* __restrict__ ahat,
                                     const uint32_t* __restrict__ kspec,
                                     const uint32_t* __restrict__ kshoup,
                                     const uint32_t* __restrict__ tables,
                                     const int64_t* __restrict__ xcrt,
                                     int64_t* __restrict__ acc_out, int B,
                                     int n_steps, int G, int M, int N,
                                     int log_n, int base_log, int levels,
                                     int bits) {
  extern __shared__ uint4 core_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int P = (int)cluster.num_blocks();
  const int pi = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const long long b = blockIdx.x / P;
  const int LJ = levels * G;
  const int OM = G * M;
  const int stride = N >> kLogRadix;
  uint64_t* acc = reinterpret_cast<uint64_t*>(core_smem);  // [G, N]
  int32_t* dig = reinterpret_cast<int32_t*>(acc + G * N);  // [LJ, N]
  uint32_t* buf = reinterpret_cast<uint32_t*>(dig + LJ * N);  // exchange
  const Plan pl = make_plan(log_n);
  const uint32_t* tab = tables + (long long)pi * (kHeader + 2 * pl.words);
  const uint64_t mask = bits == 64 ? ~0ull : 0xFFFFFFFFull;
  const int64_t* row = xcrt + pi * tfhe_pbs::kXcrtWidth;
  const uint32_t p = (uint32_t)row[0];
  const uint32_t w = (uint32_t)row[1];
  const uint32_t wsh = (uint32_t)row[2];
  const Xcrt x = load_xcrt(xcrt, P);
  const uint32_t* cs[tfhe_pbs::kMaxPrimes];
  uint64_t* accs[tfhe_pbs::kMaxPrimes];
#pragma unroll
  for (int i = 0; i < tfhe_pbs::kMaxPrimes; ++i) {
    cs[i] = i < P ? cluster.map_shared_rank(buf, i) : buf;
    accs[i] = i < P ? cluster.map_shared_rank(acc, i) : acc;
  }
  const int share = (G * N + P - 1) / P;
  const int end = min(G * N, (pi + 1) * share);

  const int64_t* src = acc_in + b * G * N;
  for (int idx = tid; idx < G * N; idx += blockDim.x)
    acc[idx] = (uint64_t)src[idx];
  __syncthreads();

  const long long kblock = (long long)LJ * OM * N;
  for (int s = 0; s < n_steps; ++s) {
    const int a_rot = ahat[(long long)s * B + b] & (2 * N - 1);  // 2N is 0
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int k = 0; k < kRadix; ++k) {
        const int j = tid + k * stride;
        tfhe_pbs::decompose_word(
            tfhe_pbs::rotated_diff((const int64_t*)acc + g * N, a_rot, j, N,
                                   mask),
            base_log, levels, bits, mask, [&](int lvl, int32_t digit) {
              dig[(lvl * G + g) * N + j] = digit;
            });
      }
    }
    const long long at = ((long long)s * P + pi) * kblock;
    external_product_prime<LJ_MAX>(
        buf, LJ, OM, N, pl, tab, kspec + at, kshoup + at,
        [&](int lj, int k) { return dig[lj * N + tid + k * stride]; },
        [&](int om, int k, uint32_t v) {
          buf[om * N + swz(tid + k * stride)] =
              shoup_canonical(v, w, wsh, p);
        });
    // every prime's values are ready, and every CTA has read its acc
    cluster.sync();
    for (int idx = pi * share + tid; idx < end; idx += blockDim.x) {
      const uint64_t v = crt_word(cs, x, P, idx >> log_n, M, N,
                                  idx & (N - 1), acc[idx]) & mask;
#pragma unroll
      for (int i = 0; i < tfhe_pbs::kMaxPrimes; ++i)
        if (i < P) accs[i][idx] = v;
    }
    // the new accumulator is in every CTA, and the values are consumed
    cluster.sync();
  }

  int64_t* dst = acc_out + b * G * N;
  for (int idx = pi * share + tid; idx < end; idx += blockDim.x)
    dst[idx] = (int64_t)acc[idx];
}

// K7: n_steps steps of the blind rotation, CTA b owning ciphertext b, N/8
// threads.  ahat [n_steps, B]; kspec, kshoup [n_steps, P, LJ, O, M, N];
// xcrt [P, kXcrtWidth] (pbs_kernels.cuh).  acc_out may not alias acc_in.
template <int LJ_MAX>
__global__ void __launch_bounds__(256, min_ctas<LJ_MAX>() > 2 ? 2 : 1)
    blind_rotate_core_kernel(const int64_t* __restrict__ acc_in,
                             const int32_t* __restrict__ ahat,
                             const uint32_t* __restrict__ kspec,
                             const uint32_t* __restrict__ kshoup,
                             const uint32_t* __restrict__ tables,
                             const int64_t* __restrict__ xcrt,
                             int64_t* __restrict__ acc_out, int B,
                             int n_steps, int G, int M, int P, int N,
                             int log_n, int base_log, int levels, int bits) {
  extern __shared__ uint4 core_smem[];
  const int tid = threadIdx.x;
  const long long b = blockIdx.x;
  const int LJ = levels * G;
  const int OM = G * M;
  const int stride = N >> kLogRadix;
  uint64_t* acc = reinterpret_cast<uint64_t*>(core_smem);  // [G, N]
  uint32_t* frac = reinterpret_cast<uint32_t*>(acc + G * N);  // [OM, N]
  int32_t* dig = reinterpret_cast<int32_t*>(frac + OM * N);  // [LJ, N]
  uint32_t* buf = reinterpret_cast<uint32_t*>(dig + LJ * N);  // exchange
  const Plan pl = make_plan(log_n);
  const int tab_words = kHeader + 2 * pl.words;
  const uint64_t mask = bits == 64 ? ~0ull : 0xFFFFFFFFull;

  const int64_t* src = acc_in + b * G * N;
  for (int idx = tid; idx < G * N; idx += blockDim.x)
    acc[idx] = (uint64_t)src[idx];
  for (int idx = tid; idx < OM * N; idx += blockDim.x) frac[idx] = 0;
  __syncthreads();

  const long long kblock = (long long)LJ * OM * N;
  const uint64_t q = (uint64_t)xcrt[5];
  for (int s = 0; s < n_steps; ++s) {
    const int a_rot = ahat[(long long)s * B + b] & (2 * N - 1);  // 2N is 0
    // 1. the digits of acc * X^a - acc at this thread's positions
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int k = 0; k < kRadix; ++k) {
        const int j = tid + k * stride;
        tfhe_pbs::decompose_word(
            tfhe_pbs::rotated_diff((const int64_t*)acc + g * N, a_rot, j, N,
                                   mask),
            base_log, levels, bits, mask, [&](int lvl, int32_t digit) {
              dig[(lvl * G + g) * N + j] = digit;
            });
      }
    }
    // 2. each prime's external product and its share of the explicit CRT:
    //    c = r N^-1 (Q/p)^-1 mod p, acc += c (Q/p) in plane m, frac += c
    //    round(2^28 / p) (ntt._explicit_crt_host)
    const uint32_t* ks = kspec + s * P * kblock;
    const uint32_t* ksh = kshoup + s * P * kblock;
    for (int pi = 0; pi < P; ++pi) {
      const int64_t* row = xcrt + pi * tfhe_pbs::kXcrtWidth;
      const uint32_t p = (uint32_t)row[0];
      const uint32_t w = (uint32_t)row[1];
      const uint32_t wsh = (uint32_t)row[2];
      const uint64_t q_i = (uint64_t)row[3];
      const uint32_t t = (uint32_t)row[4];
      external_product_prime<LJ_MAX>(
          buf, LJ, OM, N, pl, tables + pi * tab_words, ks + pi * kblock,
          ksh + pi * kblock,
          [&](int lj, int k) { return dig[lj * N + tid + k * stride]; },
          [&](int om, int k, uint32_t x) {
            const int n = tid + k * stride;
            const uint32_t cc = shoup_canonical(x, w, wsh, p);
            frac[om * N + n] += cc * t;
            const int m = M == 2 ? (om & 1) : 0;
            acc[(om / M) * N + n] += ((uint64_t)cc * q_i) << (32 * m);
          });
    }
    // 3. the correction by round(frac) * Q, at this thread's positions
    for (int o = 0; o < G; ++o) {
#pragma unroll
      for (int k = 0; k < kRadix; ++k) {
        const int n = tid + k * stride;
        uint64_t v = acc[o * N + n];
        for (int m = 0; m < M; ++m) {
          uint32_t* f = frac + (o * M + m) * N + n;
          const uint64_t kq =
              (*f + (1u << (tfhe_pbs::kFracBits - 1))) >> tfhe_pbs::kFracBits;
          v -= (kq * q) << (32 * m);
          *f = 0;
        }
        acc[o * N + n] = v & mask;
      }
    }
    __syncthreads();  // the next step's rotation reads every position
  }

  int64_t* dst = acc_out + b * G * N;
  for (int idx = tid; idx < G * N; idx += blockDim.x)
    dst[idx] = (int64_t)acc[idx];
}

}  // namespace tfhe_core
