// K2, K4, K5, K6's per-prime stage and K7 on the register-resident NTT
// core (ntt_core.cuh), for Hopper (sm_90a):
//
//   external_product_cluster_kernel   <- fused_blind_rotate_scan2 (:1213)
//                                        -> pc_kernel (:1244)
//                                        -> _primes_crt_math (:1069)  (K2)
//   pbs_step_cluster_kernel           <- fused_blind_rotate_scan1w (:965)
//                                        -> step_kernel (:983)
//                                        -> _primes_crt_math_wide (:826)
//                                                                     (K4)
//                                     <- fused_blind_rotate_scan1 (:1281)
//                                        -> step_kernel (:1304)
//                                        -> _step_math_onekernel (:809)
//                                                                     (K3)
//   blind_rotate_stream_cluster_kernel <- fused_blind_rotate_grid (:1341)
//                                        -> _make_grid_kernel (:1020) (K5)
//   ntt_mac_prime_kernel              <- fused_blind_rotate_scan (:1470)
//                                        -> prime_kernel (:1503)
//                                        -> _prime_block (:672)       (K6)
//   blind_rotate_core_kernel,         <- fused_blind_rotate_planes (:1545)
//   blind_rotate_cluster_core_kernel     -> _make_kernel (:1403)
//                                        -> _step_math (:755)         (K7)
// (lines of tfhe_tpu/ops/fused_pbs.py).  Layouts are those of
// pbs_kernels.cuh; `tables` is ntt.pass_tables_for(N) [P, kHeader + 2 W],
// `xcrt` the explicit CRT's constants [P, 6] (ntt._explicit_crt_host).
// All take LJ = L*G <= kMaxDigitPolys (18; the WoPBS catalog's widest
// set) and 256 <= N <= 2048; their launchers (core_launch.cuh) refuse anything
// else.  Registers from `nvcc -Xptxas -v` (sm_90a, the card's toolkit),
// none spilled unless said, for LJ <= 2 / 4 / 9: external_product_cluster
// 80 / 110 / 150, pbs_step_cluster 79 / 110 / 154,
// blind_rotate_stream_cluster 80 / 128 (4 bytes spilled) / 168 (capped),
// ntt_mac_prime 80 / 96 / 148 (one CTA) and 78 / 104 / 146 (a pair),
// blind_rotate_core 102 / 120 / 162, blind_rotate_cluster_core 128 / 182 /
// 226.
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
//
// K4, first design: K7's first form with one step, one CTA of 512 threads
// per ciphertext running the five primes in turn on the shared-memory
// core (11 + 11 stage barriers a prime, scalar key loads, `%` digits), 128
// KB of shared memory at PARAM_MESSAGE_2_CARRY_2_KS_PBS, so one CTA an SM;
// 0.165 ms a step at B = 64 (36x its bound), 0.33 at B = 256.  New, one
// launch a step either way: pbs_step_cluster_kernel, K2's cluster with
// the rotation and decomposition inside, each CTA making 1/P of the
// digits; or, when the batch fills the card in fewer waves that way, K7's
// blind_rotate_core_kernel over one step (single_cta_kernels.cu picks by
// K7's rule).  On an H100: 0.030 ms (shortint, B = 64, the cluster), 0.095
// (B = 256, one CTA per ciphertext: the clusters would take 4 waves, 0.114
// ms), 0.025 and 0.058 at boolean width (clusters).
//
// K3, first design: K5's first kernel (below) with one step, a cluster
// of 5 CTAs of 512 threads on the shared-memory core
// (Garner's CRT over distributed shared memory); 0.0454 ms at boolean
// width and 0.1370 at shortint width, B = 64, 23x and 30x its bound.  The
// TPU's K3 and K4 compute the same exact step; they differ only in how
// Mosaic splits it into ops (fused_pbs.py:826-835), a TPU scheduling
// artefact.  So on Hopper K3 is K4's kernel, through K4's C entry point
// (single_cta_kernels.cu), its launches counted as K3's.
//
// K5, first design: a cluster of 5 CTAs of 512 threads per ciphertext on
// the shared-memory core for all n steps, each CTA holding a whole copy of
// the accumulator (80 KB of shared memory at
// PARAM_MESSAGE_2_CARRY_2_KS_PBS, two CTAs an SM) and running K2's first
// step (stage barriers, scalar key loads, `%` digits, Garner's CRT over
// distributed shared memory); 110.3 ms a rotation at shortint width (742
// steps) and 30.3 at boolean width (722), B = 64, 33x and 21x its bound.
// New: blind_rotate_stream_cluster_kernel, K4's step (cluster_step) looped
// over the n steps in one launch, the accumulator in place in the output
// (L2), K4's 48 KB a CTA at shortint width, so one wave of 69 clusters at
// B = 64.  On an H100: 23.8 ms (shortint, B = 64), 91.5 (B = 256, 4
// waves), 19.1 and 42.7 at boolean width (1 and 2 waves of 146 clusters).
// Holding each CTA's share of the accumulator in shared memory instead,
// the rotated words read over distributed shared memory, was 0.3-2%
// slower.
//
// K6's per-prime stage, first design: a MAC kernel on the old shared-memory
// core, one CTA of 512 threads per ciphertext, 22 stage
// barriers, scalar key loads, `%` digits; 0.0332 ms at shortint width and
// B = 64.  New: ntt_mac_prime_kernel, external_product_prime for the one
// prime, its outputs scaled by N^-1 (the pass table's header) and written
// canonical at each thread's own words.  At B = 64 one CTA per ciphertext
// leaves half the SMs idle, so the launcher (pbs_kernels.cu) splits each
// ciphertext over a cluster of two when all the pairs fit on the card at
// once: each CTA transforms half the digits, they swap spectra through
// distributed shared memory, each runs half the outputs.  On an H100:
// 0.0094 ms (shortint, B = 64, a pair; one CTA 0.0111), 0.0152 (B = 256,
// one CTA; a pair 0.0229), 0.0128 and 0.0164 at boolean width (pairs).

#pragma once

#include <cooperative_groups.h>
#include <stdint.h>

#include "ntt_core.cuh"
#include "pbs_kernels.cuh"

namespace tfhe_core {

namespace cg = cooperative_groups;

// The digit polynomials (L*G) every kernel on the core takes, in its 2-,
// 4-, 9- and 18-digit variants (the WoPBS catalog's sets reach L*G = 18);
// the launchers refuse more (core_refuses).
constexpr int kMaxDigitPolys = 18;

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
// c_i = r_i N^-1 (Q/p_i)^-1 mod p_i, value(i, w) giving word w of prime i's
// [OM, N] (swizzled) in its CTA's shared memory, and consts(i, q_i, t_i)
// prime i's Q/p_i mod 2^64 and round(2^28 / p_i): per plane m, sum_i c_i
// q_i minus round(sum_i c_i t_i / 2^28) Q, shifted by 32 m bits, all mod
// 2^64 (Q = Q mod 2^64).  The same words as blind_rotate_core_kernel's
// running sums and correction.
template <typename Value, typename Consts>
__device__ __forceinline__ uint64_t crt_word(Value value, Consts consts,
                                             uint64_t Q, int P, int o, int M,
                                             int N, int n, uint64_t total) {
  for (int m = 0; m < M; ++m) {
    const int at = (o * M + m) * N + swz(n);
    uint64_t sum = 0;
    uint32_t frac = 0;
#pragma unroll
    for (int i = 0; i < tfhe_pbs::kMaxPrimes; ++i) {
      if (i < P) {
        const uint32_t c = value(i, at);
        uint64_t q;
        uint32_t t;
        consts(i, q, t);
        sum += (uint64_t)c * q;
        frac += c * t;
      }
    }
    const uint64_t k = (frac + (1u << (tfhe_pbs::kFracBits - 1))) >>
                       tfhe_pbs::kFracBits;
    total += (sum - k * Q) << (32 * m);
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

// One prime of a cluster's external product of one ciphertext, then the
// explicit CRT over the cluster, as K2, K4 and K5 run it: CTA rank i runs
// prime i (N/8 threads) and leaves its values c_i at its own words of buf;
// after a cluster barrier each CTA takes the words [i share, (i + 1)
// share) of the G*N output words (share = ceil(G N / P)) and reads the P
// CTAs' values through distributed shared memory: word idx of the new
// accumulator is old(at, idx) + the product, handed to store(at, idx, v),
// where at = (blockIdx.x / P) G N is the cluster's ciphertext's first word
// in a [B, G, N] tensor (found after the transforms, so that no pointer of
// its row stays in a register through them); digit(lj, k) as in
// external_product_prime.  A CTA reads and stores only its own share's
// words, each by the same thread, so old and store may name one buffer.
// kLeanCrt reads each prime's value window and constants as the CRT needs
// them, where P window pointers and the P primes' constants held in
// registers (some 40) would make K4 spill at the 80 registers of its
// LJ <= 2 variant; held, they keep K2 faster.
template <int LJ_MAX, bool kLeanCrt, typename Digit, typename Old,
          typename Store>
__device__ __forceinline__ void cluster_external_product(
    uint32_t* buf, Digit digit, const uint32_t* __restrict__ kspec,
    const uint32_t* __restrict__ kshoup, const uint32_t* __restrict__ tables,
    const int64_t* __restrict__ xcrt, Old old, Store store, int LJ, int G,
    int M, int N, int log_n, int bits) {
  cg::cluster_group cluster = cg::this_cluster();
  const int P = (int)cluster.num_blocks();
  const int pi = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int OM = G * M;
  const Plan pl = make_plan(log_n);
  const uint32_t* tab = tables + (long long)pi * (kHeader + 2 * pl.words);
  const int stride = N >> kLogRadix;
  const long long kblock = (long long)LJ * OM * N;
  const int64_t* row = xcrt + pi * tfhe_pbs::kXcrtWidth;
  const uint32_t p = (uint32_t)row[0];
  const uint32_t w = (uint32_t)row[1];
  const uint32_t wsh = (uint32_t)row[2];
  external_product_prime<LJ_MAX>(
      buf, LJ, OM, N, pl, tab, kspec + pi * kblock, kshoup + pi * kblock,
      digit, [&](int om, int k, uint32_t x) {
        buf[om * N + swz(tid + k * stride)] = shoup_canonical(x, w, wsh, p);
      });
  cluster.sync();  // every prime's values are in its CTA's buf

  const uint64_t mask = bits == 64 ? ~0ull : 0xFFFFFFFFull;
  const long long at = blockIdx.x / P * (long long)(G * N);
  const int share = (G * N + P - 1) / P;
  const int end = min(G * N, (pi + 1) * share);
  auto crt = [&](auto value, auto consts, uint64_t Q) {
    for (int idx = pi * share + tid; idx < end; idx += blockDim.x)
      store(at, idx, crt_word(value, consts, Q, P, idx >> log_n, M, N,
                              idx & (N - 1), old(at, idx)) &
                         mask);
  };
  if constexpr (kLeanCrt) {
    crt([&](int i, int w) { return cluster.map_shared_rank(buf, i)[w]; },
        [&](int i, uint64_t& q, uint32_t& t) {
          const int64_t* r = xcrt + i * tfhe_pbs::kXcrtWidth;
          q = (uint64_t)__ldg(r + 3);
          t = (uint32_t)__ldg(r + 4);
        },
        (uint64_t)__ldg(xcrt + 5));
  } else {
    const uint32_t* cs[tfhe_pbs::kMaxPrimes];
#pragma unroll
    for (int i = 0; i < tfhe_pbs::kMaxPrimes; ++i)
      cs[i] = i < P ? cluster.map_shared_rank(buf, i) : buf;
    const Xcrt x = load_xcrt(xcrt, P);
    crt([&](int i, int w) { return cs[i][w]; },
        [&](int i, uint64_t& q, uint32_t& t) {
          q = x.q[i];
          t = x.t[i];
        },
        x.Q);
  }
  cluster.sync();  // no CTA leaves while another reads its buf
}

// cluster_external_product's old and store on a [B, G, N] tensor in device
// memory
__device__ __forceinline__ auto old_from(const int64_t* acc) {
  return [=](long long at, int idx) { return (uint64_t)acc[at + idx]; };
}

__device__ __forceinline__ auto store_to(int64_t* out) {
  return [=](long long at, int idx, uint64_t v) { out[at + idx] = (int64_t)v; };
}

// K2 in one launch: a cluster of P CTAs per ciphertext (grid B * P), the
// digits [B, L, G, N] read from device memory at each thread's own words.
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
  const long long b = blockIdx.x / cg::this_cluster().num_blocks();
  const int stride = N >> kLogRadix;
  const int32_t* dig = digits + b * LJ * N + threadIdx.x;
  cluster_external_product<LJ_MAX, false>(
      buf, [&](int lj, int k) { return dig[lj * N + k * stride]; }, kspec,
      kshoup, tables, xcrt, old_from(acc), store_to(out), LJ, G, M, N, log_n,
      bits);
}

// K4's step on a cluster (its body, and K5's every step): CTA rank i makes
// the digits of acc * X^a - acc (a in [0, 2N)) at the words of its share
// of the thread indices, tid in [floor(i T / P), floor((i + 1) T / P)) (T
// = N/8 threads a CTA; thread tid owns the words tid + k N/8 of each
// polynomial), into its `dig` [LJ, N], reading the cluster's ciphertext's
// accumulator [G, N] at row; after a cluster barrier each thread reads its
// own words' digits from the one CTA that made them, through distributed
// shared memory, and the cluster runs cluster_external_product with old
// and store.  No digits in device memory, and each CTA makes 1/P of them.
// On return every word of the new accumulator is stored and a cluster
// barrier has passed.
template <int LJ_MAX, typename Old, typename Store>
__device__ __forceinline__ void cluster_step(
    uint32_t* buf, int32_t* dig, const int64_t* row, int a_rot,
    const uint32_t* __restrict__ kspec, const uint32_t* __restrict__ kshoup,
    const uint32_t* __restrict__ tables, const int64_t* __restrict__ xcrt,
    Old old, Store store, int LJ, int G, int M, int N, int log_n,
    int base_log, int levels, int bits) {
  cg::cluster_group cluster = cg::this_cluster();
  const int P = (int)cluster.num_blocks();
  const int pi = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int T = N >> kLogRadix;  // threads a CTA, and the stride of k
  const uint64_t mask = bits == 64 ? ~0ull : 0xFFFFFFFFull;
  // this CTA's share: threads v0 .. v0 + n - 1, all k and g, n G 8 words
  // over T threads, f = ((g 8 + k) n + v - v0); one word at a time, which
  // keeps the 64-bit words' registers within the transforms' budget
  const int v0 = pi * T / P;
  const int n = (pi + 1) * T / P - v0;
#pragma unroll 1
  for (int f = tid; f < n * G * kRadix; f += T) {
    const int gk = f / n;
    const int j = v0 + f - gk * n + (gk & (kRadix - 1)) * T;
    const int g = gk >> kLogRadix;
    tfhe_pbs::decompose_word(
        tfhe_pbs::rotated_diff(row + g * N, a_rot, j, N, mask), base_log,
        levels, bits, mask, [&](int lvl, int32_t digit) {
          dig[(lvl * G + g) * N + j] = digit;
        });
  }
  cluster.sync();  // every CTA's share of the digits is made
  // the CTA that made this thread's digits: the i with
  // floor(i T / P) <= tid < floor((i + 1) T / P)
  const int32_t* mine =
      cluster.map_shared_rank(dig, ((tid + 1) * P - 1) / T) + tid;
  cluster_external_product<LJ_MAX, (LJ_MAX <= 2)>(
      buf, [&](int lj, int k) { return mine[lj * N + k * T]; }, kspec, kshoup,
      tables, xcrt, old, store, LJ, G, M, N, log_n, bits);
}

// K4, a whole step in one launch: K2's cluster with K1's rotation and
// decomposition inside (cluster_step), acc [B, G, N] and ahat [B] read
// from device memory.  Shared memory: max(LJ, OM) + LJ polynomials.
template <int LJ_MAX>
__global__ void __launch_bounds__(256, min_ctas<LJ_MAX>())
    pbs_step_cluster_kernel(const int64_t* __restrict__ acc,
                            const int32_t* __restrict__ ahat,
                            const uint32_t* __restrict__ kspec,
                            const uint32_t* __restrict__ kshoup,
                            const uint32_t* __restrict__ tables,
                            const int64_t* __restrict__ xcrt,
                            int64_t* __restrict__ out, int LJ, int G, int M,
                            int N, int log_n, int base_log, int levels,
                            int bits) {
  extern __shared__ uint4 core_smem[];
  const int OM = G * M;
  uint32_t* buf = reinterpret_cast<uint32_t*>(core_smem);
  int32_t* dig = reinterpret_cast<int32_t*>(buf + (LJ > OM ? LJ : OM) * N);
  const long long b = blockIdx.x / cg::this_cluster().num_blocks();
  cluster_step<LJ_MAX>(buf, dig, acc + b * G * N, ahat[b] & (2 * N - 1),
                       kspec, kshoup, tables, xcrt, old_from(acc),
                       store_to(out), LJ, G, M, N, log_n, base_log, levels,
                       bits);
}

// K5, all n_steps steps of the blind rotation in one launch: K4's cluster
// step looped on chip, a cluster of P CTAs per ciphertext (grid B * P, N/8
// threads), the step's key slice streamed from device memory (mostly L2).
// ahat [n_steps, B]; kspec, kshoup [n_steps, P, LJ, O, M, N]; acc_in,
// acc_out [B, G, N], which may not alias.  The accumulator lives in
// acc_out, updated in place (32 KB a ciphertext at
// PARAM_MESSAGE_2_CARRY_2_KS_PBS, so 2 MB at B = 64, resident in L2).
// Each CTA writes only its CRT share of a ciphertext's [G, N], words
// [pi share, (pi + 1) share), each word always by the same thread: first
// its copy of acc_in, then every step's new word.  A step reads arbitrary
// words (the rotation) only before its first cluster barrier and writes
// after it; its second cluster barrier (release / acquire at cluster
// scope) orders those writes before the next step's reads.  acc_out is
// neither const __restrict__ nor read through __ldg, so no load of it may
// go through the non-coherent path (ld.global.nc), which could return a
// previous step's word.  Shared memory: max(LJ, OM) + LJ polynomials.
// Registers: at most kStreamRegs (K4's launch bounds, but 168 for LJ_MAX
// = 9, where the step loop would take 206 and leave 4 CTAs of 64 threads
// an SM at boolean DEFAULT_PARAMETERS width instead of the 6 its shared
// memory allows; the 18-digit variant's digit spectra alone take 144, so
// it has the 255 a thread may hold).
template <int LJ_MAX>
constexpr int kStreamRegs =
    LJ_MAX <= 2 ? 80 : (LJ_MAX <= 4 ? 128 : (LJ_MAX <= 9 ? 168 : 255));

template <int LJ_MAX>
__global__ void __maxnreg__(kStreamRegs<LJ_MAX>)
    blind_rotate_stream_cluster_kernel(
        const int64_t* __restrict__ acc_in, const int32_t* __restrict__ ahat,
        const uint32_t* __restrict__ kspec,
        const uint32_t* __restrict__ kshoup,
        const uint32_t* __restrict__ tables,
        const int64_t* __restrict__ xcrt, int64_t* acc_out, int B,
        int n_steps, int G, int M, int N, int log_n, int base_log,
        int levels, int bits) {
  extern __shared__ uint4 core_smem[];
  const int LJ = levels * G;
  const int OM = G * M;
  uint32_t* buf = reinterpret_cast<uint32_t*>(core_smem);
  int32_t* dig = reinterpret_cast<int32_t*>(buf + (LJ > OM ? LJ : OM) * N);
  cg::cluster_group cluster = cg::this_cluster();
  const int P = (int)cluster.num_blocks();
  const int pi = (int)cluster.block_rank();
  const long long b = blockIdx.x / P;
  const int share = (G * N + P - 1) / P;
  const int end = min(G * N, (pi + 1) * share);
  int64_t* row = acc_out + b * G * N;
  for (int idx = pi * share + threadIdx.x; idx < end; idx += blockDim.x)
    row[idx] = acc_in[b * G * N + idx];
  cluster.sync();  // the whole accumulator is in place

  const long long kstep = (long long)P * LJ * OM * N;  // one step's keys
  for (int s = 0; s < n_steps; ++s) {
    const int a_rot = ahat[(long long)s * B + b] & (2 * N - 1);  // 2N is 0
    cluster_step<LJ_MAX>(buf, dig, row, a_rot, kspec + s * kstep,
                         kshoup + s * kstep, tables, xcrt, old_from(acc_out),
                         store_to(acc_out), LJ, G, M, N, log_n, base_log,
                         levels, bits);
  }
}

// K6's per-prime stage: prime `prime`'s external product of ciphertext
// blockIdx.x / kParts, its residues r N^-1 mod p written canonical into
// residues [B, O, M, P, N] at the thread's own words; by one CTA of N/8
// threads or (kParts = 2) a cluster of two, each transforming half of the
// digits and emitting half of the outputs (external_product_prime).
// digits [B, L, G, N]; kspec / kshoup the prime's key block [LJ, O, M, N].
// Shared memory: max(LJ, OM) polynomials.
template <int LJ_MAX, int kParts>
__global__ void __launch_bounds__(256, min_ctas<LJ_MAX>())
    ntt_mac_prime_kernel(const int32_t* __restrict__ digits,
                         const uint32_t* __restrict__ kspec,
                         const uint32_t* __restrict__ kshoup,
                         const uint32_t* __restrict__ tables,
                         uint32_t* __restrict__ residues, int LJ, int OM,
                         int N, int log_n, int prime, int P) {
  extern __shared__ uint4 core_smem[];
  uint32_t* buf = reinterpret_cast<uint32_t*>(core_smem);
  const long long b = blockIdx.x / kParts;
  const int stride = N >> kLogRadix;
  const Plan pl = make_plan(log_n);
  const uint32_t* tab = tables + (long long)prime * (kHeader + 2 * pl.words);
  const uint32_t p = __ldg(tab);
  const uint2 ninv = __ldg(reinterpret_cast<const uint2*>(tab + 4));
  const int32_t* dig = digits + b * LJ * N + threadIdx.x;
  uint32_t* res = residues + (b * OM * P + prime) * N + threadIdx.x;
  external_product_prime<LJ_MAX, kParts>(
      buf, LJ, OM, N, pl, tab, kspec, kshoup,
      [&](int lj, int k) { return dig[lj * N + k * stride]; },
      [&](int om, int k, uint32_t x) {
        res[(long long)om * P * N + k * stride] =
            shoup_canonical(x, ninv.x, ninv.y, p);
      });
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
      const uint64_t v =
          crt_word([&](int i, int w) { return cs[i][w]; },
                   [&](int i, uint64_t& q, uint32_t& t) {
                     q = x.q[i];
                     t = x.t[i];
                   },
                   x.Q, P, idx >> log_n, M, N, idx & (N - 1), acc[idx]) &
          mask;
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
