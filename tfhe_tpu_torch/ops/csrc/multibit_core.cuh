// K9, the multi-bit group step, in one launch on the register-resident NTT
// core (ntt_core.cuh), for Hopper (sm_90a), and K8's external product with
// the per-ciphertext combined key on the same kernel:
//
//   multibit_step_cluster_kernel<., false>  <- fused_multibit_rotate_scan1
//                                    (:508) -> step_kernel (:539)
//                                    -> _mb_step_math_onekernel (:368)
//   multibit_step_cluster_kernel<., true>   <- fused_multibit_rotate_scan
//                                    (:702) -> mac_kernel (:823), with its
//                                    digits (_dec_limbs :264, called at
//                                    :828)
// (lines of tfhe_tpu/ops/fused_multibit.py).
//
// One group step of gf mask elements replaces the accumulator by the
// external product of the combined GGSW K = K_0 + sum_{j >= 1} X^{d_j} K_j
// with it: digits D_lj of the accumulator itself (no rotation), then per
// prime and output om
//     sum_j mon_j(n) * sum_lj D_lj(n) K_j,lj,om(n),
// mon_j(n) = psi^(d_j e(n) mod 2N) the spectrum of X^{d_j} (mon_0 = 1),
// then the inverse transforms and a CRT that starts from zero.
//
// First design: decompose, then multibit_step_kernel (one CTA of
// 512 threads per (ciphertext, prime) on the shared-memory core of
// pbs_kernels.cuh: `%` digits, a barrier a radix-2 stage, scalar key and
// companion loads, the monomial gathered per coefficient from a padded
// shared copy of the 2N powers), then a CRT launch from zero over
// residues in device memory: three launches a group step, 0.2257 ms at
// PARAM_MULTI_BIT_MESSAGE_2_CARRY_2_GROUP_3_KS_PBS and B = 64 on an H100,
// 20x its bound by operations.
//
// New: one launch a group step, on K4's cluster (pbs_step_cluster_kernel):
// P CTAs of N/8 threads per ciphertext, one prime each.  Each thread makes
// the digits of its own words straight from the accumulator (a word's
// digits need no other word: no digit buffer, no barrier); the forward
// transforms run in registers (forward_transforms), the spectra, reduced
// into [0, 2p), wait in shared memory at the thread's own words; the subset
// MAC below, kMbChunk outputs at a time; the inverse transforms
// (inverse_transforms); the explicit CRT from zero over the cluster's
// shared memory into the new accumulator.
//
// The MAC.  Thread tid holds the spectral words n = tid * 8 + k, k < 8, the
// PreparedBskCuda layout's own index, so e(n) = 2 bitrev(n) + 1 splits as
// e(tid * 8) + bitrev3(k) N/4 (checked on the CPU by
// tests/test_torch_multibit_core.py): mon_j(n) = psi^(d_j e(tid * 8)) *
// w^m, m = d_j bitrev3(k) mod 8, w = psi^(N/4) an 8th root of unity.  The
// first factor is one gather per thread and subset (with its Shoup
// companion); since w^(m + 4) = -w^m, the second is a product by w, w^2 or
// w^3 (held in registers) when m mod 4 != 0 and a negation when m >= 4, m
// the same for the whole CTA.  The monomial multiplies the digit spectra,
// not the outputs:
//     sum_j sum_lj (mon_j D_lj) K_j,lj,om,
// LJ products a subset instead of O*M.  Each product of a word at most 2p
// by a key word below p < 2^26.83 is below 2^54.66, and is summed exactly
// in 64 bits (one 32 x 32 + 64 multiply-add each): at most 2^gf LJ <= 16 *
// 18 = 288 terms, below 2^62.83.  One reduction per output word
// (ntt_core.cuh reduce_u64: the low word and the high word times 2^32 mod
// p, a Shoup product each) brings the whole sum into [0, 2p) for the
// inverse transform, so the MAC reads no key companions.
//
// K8's MAC (kCombined): the same kernel with one subset, no monomial, and
// the key of the ciphertext's own combined GGSW (multibit_combine,
// multibit_kernels.cuh) in place of the subset keys; its sums hold LJ <= 18
// terms, below 2^58.83.  It replaces the first port's two launches:
// a MAC kernel of one CTA of 512 threads per (ciphertext, prime) on the old
// shared-memory core (a barrier a radix-2 stage, Barrett products of the
// combined key) over digits read from device memory, then a CRT launch from
// zero over residues in device memory; 0.0925 ms with the digits' launch
// at GROUP_3 width and B = 64 on an H100, against 0.0310 for this form
// (kernel_times.py; 4 outputs a chunk instead of kMbChunk's 2: 0.0404).
// Registers (-Xptxas -v, sm_90a) for LJ <= 2 / 4 / 9 / 18: 76 / 105 /
// 151 / 235, no spill; K9's form 80 (16 bytes spilled) / 126 / 182 / 254.
//
// The key's primes and planes.  P (the cluster's CTAs) and M come from the
// key: ntt.classic_plan's rule for a key word summed from 2^gf words, four
// of ntt.WIDE_PRIMES and one plane at every copied set with N <= 2048,
// where the reference's five primes below 2^17 took two planes (which the
// kernel still takes).  At GROUP_3 width that is 16 transforms and 16
// spectral products a ciphertext and step instead of 30 and 40, a cluster
// of 4 CTAs, (2 + 2) N 4 = 32 KB of shared memory a CTA instead of 48, and
// a 128-KB combined key a ciphertext instead of 320.
//
// What bounds it, measured on an H100 with kernel_times.py (PERF.md
// section 6): latency and issue in the MAC, not key traffic.  Every CTA
// reads its prime's 2^gf subset key spectra, 2^gf LJ OM N 4 bytes (512 KB
// at GROUP_3 width), from L2 at each group step, 168 MB at B = 64; with
// no key loads at all the step ran 22-24% faster, the most that any
// sharing of key loads between ciphertexts could gain, and two ciphertexts
// a cluster sharing every key load (half the CTAs, each twice the work)
// ran slower, as did copying the key through shared memory ahead of its
// use (cp.async).  The monomials cost as much: without their products the
// step ran 24-25% faster, after the root became a sign and at most one
// product.  kMbChunk outputs at a time: all four (128 registers, two CTAs
// an SM) ran 40-46% slower, one at a time (the monomials made once an
// output) 22-25% slower, than two (80 registers).  The step: 0.0643 ms at
// B = 64, 0.2278 at B = 256 (3.8x and 3.1x faster than the first design).
//
// Layouts: acc, out [B, G, N] int64 (u64 torus words); d [B, 2^gf] int32
// in [0, 2N) (d_0 is not read: subset 0 is empty); kspec [2^gf, P, LJ, G,
// M, N] uint32 canonical (K8: [B, P, LJ, G, M, N]); powers [P, 2, 2N]
// uint32 psi^t and companions (ntt.monomial_tables_for); exps [N] int32
// e(n); tables ntt.pass_tables_for(N); xcrt ntt._explicit_crt_host; all
// over the key's set of P primes.  Limits (the launcher refuses anything
// else): those of the core (LJ <= 18, 256 <= N <= 2048, P <= 8), 2^gf <=
// kMaxSubsets, M in {1, 2}, G * M <= kMaxOutputs (multibit_kernels.cuh).
#pragma once

#include <cooperative_groups.h>
#include <stdint.h>

#include "ntt_core_kernels.cuh"

namespace tfhe_core {

// output polynomials whose 64-bit sums a thread holds at once, 16 registers
// each; K9's monomial products are made again for each chunk
constexpr int kMbChunk = 2;

// shared memory of a CTA: OM output polynomials, then LJ digit spectra
inline size_t multibit_step_smem(int LJ, int OM, int N) {
  return (size_t)(OM + LJ) * N * sizeof(uint32_t);
}

__device__ __forceinline__ int bitrev3(int k) {
  return ((k & 1) << 2) | (k & 2) | (k >> 2);
}

// The signed digit of level lvl (0 the largest) of a 64-bit torus word.
__device__ __forceinline__ int32_t digit_at(uint64_t word, int base_log,
                                            int levels, int lvl) {
  int32_t out = 0;
  tfhe_pbs::decompose_word(word, base_log, levels, 64, ~0ull,
                           [&](int l, int32_t digit) {
                             if (l == lvl) out = digit;
                           });
  return out;
}

// One group step: cluster b = blockIdx.x / P owns ciphertext b, CTA rank pi
// prime pi; grid B * P, N/8 threads.  Shared memory: multibit_step_smem.
// kCombined is K8's MAC: one subset (per = 1), kspec the per-ciphertext
// combined keys [B, P, LJ, G, M, N], and deg, powers and exps not read (may
// be null).  M is the key's planes a torus word (1 or 2), P the cluster's
// CTAs, one per prime of the key's set.
template <int LJ_MAX, bool kCombined>
__global__ void __launch_bounds__(256, min_ctas<LJ_MAX>())
    multibit_step_cluster_kernel(const int64_t* __restrict__ acc,
                                 const int32_t* __restrict__ deg,
                                 const uint32_t* __restrict__ kspec,
                                 const uint32_t* __restrict__ powers,
                                 const int32_t* __restrict__ exps,
                                 const uint32_t* __restrict__ tables,
                                 const int64_t* __restrict__ xcrt,
                                 int64_t* __restrict__ out, int per, int G,
                                 int M, int N, int log_n, int base_log,
                                 int levels) {
  extern __shared__ uint4 core_smem[];
  uint32_t* buf = reinterpret_cast<uint32_t*>(core_smem);
  cg::cluster_group cluster = cg::this_cluster();
  const int P = (int)cluster.num_blocks();
  const int pi = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int T = N >> kLogRadix;  // threads a CTA, and the stride of k
  const int LJ = levels * G;
  const int OM = G * M;
  const long long b = blockIdx.x / P;
  const Plan pl = make_plan(log_n);
  const uint32_t* tab = tables + (long long)pi * (kHeader + 2 * pl.words);
  const PrimeConsts c = load_consts(tab);
  const uint32_t* fwd = tab + kHeader;
  const uint32_t* inv = fwd + pl.words;
  uint32_t* dig = buf + OM * N;  // the digit spectra, after the outputs

  // 1. the digits' transforms (lj = level G + g), reduced into [0, 2p)
  //    and kept at the thread's own words of dig: no barrier
  {
    uint32_t d[LJ_MAX][kRadix];
    int offs[kRadix];
    forward_transforms<LJ_MAX, false>(
        dig, N, pl, fwd, c, [&](int lj) { return lj < LJ ? lj : -1; },
        [&](int lj, int k) {
          return digit_at(
              (uint64_t)acc[(b * G + lj % G) * N + tid + k * T], base_log,
              levels, lj / G);
        },
        d, offs);
#pragma unroll
    for (int lj = 0; lj < LJ_MAX; ++lj) {
      if (lj < LJ) {
#pragma unroll
        for (int k = 0; k < kRadix; ++k)
          d[lj][k] = shoup_lazy(d[lj][k], 1u, c.one_sh, c.p);
        store_words(dig + lj * N, 0, offs, d[lj]);
      }
    }
  }

  // 2. per chunk of outputs: the subset MAC, each output's sums reduced
  //    into [0, 2p), inverse pass 0, the words to buf polynomial om
  int offs[kRadix];
  pass_offsets(tid, 0, offs);
  // psi^t and companions, e(tid 8), and w^1, w^2, w^3 (w = psi^(N/4)) with
  // their companions, w^(m + 4) = -w^m: K9's monomials only
  const uint32_t* pw = nullptr;
  int e0 = 0;
  uint32_t w1 = 0, w2 = 0, w3 = 0, w1sh = 0, w2sh = 0, w3sh = 0;
  if constexpr (!kCombined) {
    pw = powers + (long long)pi * 4 * N;
    e0 = __ldg(exps + tid * kRadix);
    w1 = __ldg(pw + (N >> 2));
    w2 = __ldg(pw + (N >> 1));
    w3 = __ldg(pw + 3 * (N >> 2));
    w1sh = __ldg(pw + 2 * N + (N >> 2));
    w2sh = __ldg(pw + 2 * N + (N >> 1));
    w3sh = __ldg(pw + 2 * N + 3 * (N >> 2));
  }
  const WideConsts wc = load_wide_consts(tab);
  const long long W = (long long)LJ * OM * N;  // a subset key, one prime
  // K9: subset j's key at kspec[j, pi]; K8: the ciphertext's at kspec[b, pi]
  const uint32_t* key =
      kspec + (kCombined ? b * P + pi : (long long)pi) * W + tid * kRadix;
  for (int om0 = 0; om0 < OM; om0 += kMbChunk) {
    uint64_t o[kMbChunk][kRadix];
#pragma unroll
    for (int q = 0; q < kMbChunk; ++q)
#pragma unroll
      for (int k = 0; k < kRadix; ++k) o[q][k] = 0;
    for (int j = 0; j < (kCombined ? 1 : per); ++j) {
      // mon_j = psi^(d_j e(tid 8)) w^(d_j bitrev3(k) mod 8); mon_0 = 1
      int dj = 0;
      uint32_t bw = 0, bsh = 0;
      if constexpr (!kCombined) {
        dj = __ldg(deg + b * per + j);
        const int t = (dj * e0) & (2 * N - 1);
        bw = __ldg(pw + t);
        bsh = __ldg(pw + 2 * N + t);
      }
      const uint32_t* kj = key + (long long)j * P * W;
#pragma unroll
      for (int lj = 0; lj < LJ_MAX; ++lj) {
        if (lj < LJ) {
          uint32_t dm[kRadix];
          load_words(dig + lj * N, 0, offs, dm);
          if (!kCombined && j > 0) {
#pragma unroll
            for (int k = 0; k < kRadix; ++k) {
              // w^m is the same for the whole CTA: a product for
              // m mod 4 != 0, then 2p - y (in (0, 2p]) for m >= 4
              uint32_t y = shoup_lazy(dm[k], bw, bsh, c.p);
              const int m = (dj * bitrev3(k)) & 7;
              if (m & 3) {
                const bool odd = m & 1;
                y = shoup_lazy(y, odd ? ((m & 2) ? w3 : w1) : w2,
                               odd ? ((m & 2) ? w3sh : w1sh) : w2sh, c.p);
              }
              dm[k] = m & 4 ? c.p2 - y : y;
            }
          }
#pragma unroll
          for (int q = 0; q < kMbChunk; ++q) {
            if (om0 + q < OM) {
              const uint4* kv = reinterpret_cast<const uint4*>(
                  kj + (long long)(lj * OM + om0 + q) * N);
              const uint4 k0 = __ldg(kv), k1 = __ldg(kv + 1);
              const uint32_t kk[kRadix] = {k0.x, k0.y, k0.z, k0.w,
                                           k1.x, k1.y, k1.z, k1.w};
#pragma unroll
              for (int k = 0; k < kRadix; ++k)
                o[q][k] += (uint64_t)dm[k] * kk[k];
            }
          }
        }
      }
    }
    uint32_t w[kRadix], wsh[kRadix];
    load_record(inv + tid * kRecord, w, wsh);
#pragma unroll
    for (int q = 0; q < kMbChunk; ++q) {
      if (om0 + q < OM) {
        uint32_t x[kRadix];
#pragma unroll
        for (int k = 0; k < kRadix; ++k) x[k] = reduce_u64(o[q][k], c, wc);
        inverse_stages(x, w, wsh, 0, c.p, c.p2);
        store_words(buf + (om0 + q) * N, 0, offs, x);
      }
    }
  }

  // 3. the inverse transforms; the values c_i = r_i N^-1 (Q/p_i)^-1 mod
  //    p_i at the thread's own words
  const int64_t* row = xcrt + pi * tfhe_pbs::kXcrtWidth;
  const uint32_t wi = (uint32_t)row[1];
  const uint32_t wish = (uint32_t)row[2];
  inverse_transforms(buf, OM, 0, 1, N, pl, inv, c,
                     [&](int om, int k, uint32_t x) {
                       buf[om * N + swz(tid + k * T)] =
                           shoup_canonical(x, wi, wish, c.p);
                     });
  cluster.sync();  // every prime's values are in its CTA's buf

  // 4. the explicit CRT from zero over this CTA's 1/P of the G N words
  const int share = (G * N + P - 1) / P;
  const int end = min(G * N, (pi + 1) * share);
  const uint64_t Q = (uint64_t)__ldg(xcrt + 5);
  for (int idx = pi * share + tid; idx < end; idx += blockDim.x)
    out[b * G * N + idx] = (int64_t)crt_word(
        [&](int i, int w) { return cluster.map_shared_rank(buf, i)[w]; },
        [&](int i, uint64_t& q, uint32_t& t) {
          const int64_t* r = xcrt + i * tfhe_pbs::kXcrtWidth;
          q = (uint64_t)__ldg(r + 3);
          t = (uint32_t)__ldg(r + 4);
        },
        Q, P, idx >> log_n, M, N, idx & (N - 1), 0);
  cluster.sync();  // no CTA leaves while another reads its buf
}

}  // namespace tfhe_core
