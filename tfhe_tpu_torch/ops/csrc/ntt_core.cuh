// A register-resident negacyclic NTT core for Hopper (sm_90a), and the
// per-prime external product built on it.  K2, K3 and K4 (one kernel on
// the card), K5, K6's per-prime stage and K7 (ntt_core_kernels.cuh) run
// external_product_prime; K9 (multibit_core.cuh) runs its two halves,
// forward_transforms and inverse_transforms, around a MAC of its own, and
// so does K8's external product (the same kernel, the key per ciphertext).
// No other NTT is left in the port.
//
// What bounded the old shared-memory core (once in pbs_kernels.cuh, now
// removed): a radix-2 loop that puts each of the log2 N stages
// through shared memory.  Per butterfly it makes two shared loads, two
// shared stores and two twiddle loads from device memory, and each stage
// ends in a barrier with 2-8 butterflies a thread between barriers.  So its
// time went to barrier and load latency: K2 ran at 0.0917 ms a step at
// PARAM_MESSAGE_2_CARRY_2_KS_PBS width and B = 64, 20x its bound by
// operations, and K7 at 100x (boolean) and 49x (shortint).
//
// This core:
//   - a thread holds kRadix = 8 words of a polynomial in registers and runs
//     up to three butterfly stages on them (a pass); shared memory only
//     moves words between passes: 3 or 4 passes and 2 or 3 barriers per
//     transform at N = 512 ... 2048, instead of 9-11 of each;
//   - each pass's twiddles are one 64-byte record per thread (four 16-byte
//     loads), read once for all the polynomials of the pass, from per-pass
//     tables built by `ntt._host_pass_tables` (the layout and the index
//     formulas are documented there and checked on the CPU by
//     tests/test_torch_ntt_core.py);
//   - the forward transform ends, and the inverse begins, with the stages of
//     half-distance 1, 2, 4, on 8 adjacent spectral words of one thread, so
//     the last forward pass, the spectral multiply-accumulate (MAC) against
//     the key and the first inverse pass run in registers with no barrier
//     between them; the key and its Shoup companions arrive as 16-byte
//     loads, coalesced across the warp;
//   - lazy reduction: words stay below 2^32 unreduced and Shoup products
//     accept any 32-bit operand, so a forward butterfly is three
//     multiplies and two adds, an inverse one three multiplies, two adds
//     and a min; digits are reduced with one Shoup product after an offset
//     of 2^31, without a runtime `%`.  Two conditions on each prime p keep
//     every word below 2^32 (ntt.check_headroom refuses a set that breaks
//     them): the forward transform's, 25p < 2^32 (a digit enters in
//     [0, 3p), each of at most 11 stages adds less than 2p, and the last
//     stage's input, below 23p, must stay below 2^32 - 2p); and the MAC's,
//     36p < 2^32 (its sum of LJ lazy products is below 2 LJ p, LJ <= 18).
//     Both hold for every p < 2^32 / 36 = 2^26.83: the reference's five
//     primes below 2^17 and the classic key's ntt.WIDE_PRIMES.
// Every result is canonical at the end, so the words equal the old core's.
//
// Layout of a polynomial in shared memory: word j at swz(j), a bijection of
// [0, N) that keeps every warp's access free of bank conflicts in each
// pass's layout (scalar accesses for shifts >= 3, 16-byte accesses for
// shift 0).  Thread tid holds, in the layout of shift a, the words
// elem(tid, a, k) = (tid >> a) << (a + 3) | k << a | (tid & (2^a - 1)).
#pragma once

#include <cooperative_groups.h>
#include <stdint.h>

namespace tfhe_core {

constexpr int kLogRadix = 3;
constexpr int kRadix = 1 << kLogRadix;  // words of a polynomial a thread holds
constexpr int kRecord = 2 * kRadix;     // one twiddle record, in words
constexpr int kHeader = 8;  // per-prime constants before the records:
                            // PrimeConsts, N^-1 and its companion,
                            // WideConsts
constexpr int kMinLogN = 8;             // the swizzle's and the plan's range
constexpr int kMaxLogN = 11;            // (the primes' 2N-th roots)

// p, 2p, floor(2^32 / p) (the companion of 1), p - (2^31 mod p)
struct PrimeConsts {
  uint32_t p, p2, one_sh, digit_off;
};

__device__ __forceinline__ PrimeConsts load_consts(const uint32_t* tab) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(tab));
  return PrimeConsts{a.x, a.y, a.z, a.w};
}

// a * w - floor(a * wsh / 2^32) * p, which is a * w mod p or that plus p,
// for any 32-bit a and 0 <= w < p with wsh = floor(w * 2^32 / p)
__device__ __forceinline__ uint32_t shoup_lazy(uint32_t a, uint32_t w,
                                               uint32_t wsh, uint32_t p) {
  return a * w - __umulhi(a, wsh) * p;
}

__device__ __forceinline__ uint32_t shoup_canonical(uint32_t a, uint32_t w,
                                                    uint32_t wsh, uint32_t p) {
  const uint32_t r = shoup_lazy(a, w, wsh, p);
  return min(r, r - p);
}

// 2^32 mod p and its Shoup companion, words 6 and 7 of the header: what
// brings the high word of a 64-bit sum under 2p
struct WideConsts {
  uint32_t c32, c32sh;
};

__device__ __forceinline__ WideConsts load_wide_consts(const uint32_t* tab) {
  const uint2 a = __ldg(reinterpret_cast<const uint2*>(tab + 6));
  return WideConsts{a.x, a.y};
}

// Any 64-bit x -> a word in [0, 2p) congruent to it: its low word by a
// Shoup product with 1 and its high word by one with 2^32 mod p, each in
// [0, 2p), their sum (below 4p < 2^32) less 2p if it is not below 2p.  The
// multi-bit kernels' MACs and their combine sum exact 64-bit products of
// canonical key words with words below 2p, which no 32-bit sum holds at
// primes above 2^17.
__device__ __forceinline__ uint32_t reduce_u64(uint64_t x,
                                               const PrimeConsts& c,
                                               const WideConsts& w) {
  const uint32_t r = shoup_lazy((uint32_t)x, 1u, c.one_sh, c.p) +
                     shoup_lazy((uint32_t)(x >> 32), w.c32, w.c32sh, c.p);
  return min(r, r - c.p2);
}

// a signed digit -> a word in [0, 3p) congruent to it: (d + 2^31) mod p by
// a Shoup product with 1, in [0, 2p), plus p - (2^31 mod p)
__device__ __forceinline__ uint32_t digit_mod(int32_t d,
                                              const PrimeConsts& c) {
  return shoup_lazy((uint32_t)d ^ 0x80000000u, 1u, c.one_sh, c.p) +
         c.digit_off;
}

// The pass plan of an N-point transform (ntt.pass_plan): `passes` passes;
// forward pass q has shift fwd_shift(q) and pass 0 runs only its first s0
// stages; `words` is one direction's table length.
struct Plan {
  int log_n, passes, s0, words;
  __device__ __forceinline__ int fwd_shift(int q) const {
    return q == 0 ? log_n - kLogRadix : log_n - s0 - q * kLogRadix;
  }
};

__device__ __forceinline__ Plan make_plan(int log_n) {
  Plan pl;
  pl.log_n = log_n;
  pl.passes = (log_n + kLogRadix - 1) / kLogRadix;
  pl.s0 = log_n - kLogRadix * (pl.passes - 1);
  pl.words = 0;
  for (int q = 0; q < pl.passes; ++q)
    pl.words += (1 << (log_n - pl.fwd_shift(q) - kLogRadix)) * kRecord;
  return pl;
}

__device__ __forceinline__ int elem(int tid, int a, int k) {
  return ((tid >> a) << (a + kLogRadix)) | (k << a) | (tid & ((1 << a) - 1));
}

// Bits 3-4 of the word index are XORed with bits 6-7, and bit 2 with bit 5.
// Shift 3: a warp's 32 words differ in bits 0-2 and 6-7, so in bank bits
// 0-4.  Shift 0: a thread's 8 words stay two aligned 16-byte chunks, and
// the 8 threads of a quarter-warp hit 8 different chunk columns.  Shifts
// >= 5: a warp's words differ in bits 0-4 only, so any XOR by higher bits
// keeps them apart.
__device__ __forceinline__ int swz(int j) {
  return j ^ (((j >> 6) & 3) << 3) ^ (((j >> 5) & 1) << 2);
}

// This thread's word offsets in the layout of shift a: swz(elem(tid, a, k))
__device__ __forceinline__ void pass_offsets(int tid, int a,
                                             int (&off)[kRadix]) {
#pragma unroll
  for (int k = 0; k < kRadix; ++k) off[k] = swz(elem(tid, a, k));
}

__device__ __forceinline__ void load_words(const uint32_t* poly, int a,
                                           const int (&off)[kRadix],
                                           uint32_t (&x)[kRadix]) {
  if (a == 0) {
    const uint4 lo = *reinterpret_cast<const uint4*>(poly + off[0]);
    const uint4 hi = *reinterpret_cast<const uint4*>(poly + off[4]);
    x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
    x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
  } else {
#pragma unroll
    for (int k = 0; k < kRadix; ++k) x[k] = poly[off[k]];
  }
}

__device__ __forceinline__ void store_words(uint32_t* poly, int a,
                                            const int (&off)[kRadix],
                                            const uint32_t (&x)[kRadix]) {
  if (a == 0) {
    *reinterpret_cast<uint4*>(poly + off[0]) =
        make_uint4(x[0], x[1], x[2], x[3]);
    *reinterpret_cast<uint4*>(poly + off[4]) =
        make_uint4(x[4], x[5], x[6], x[7]);
  } else {
#pragma unroll
    for (int k = 0; k < kRadix; ++k) poly[off[k]] = x[k];
  }
}

__device__ __forceinline__ void load_record(const uint32_t* rec,
                                            uint32_t (&w)[kRadix],
                                            uint32_t (&wsh)[kRadix]) {
  const uint4* v = reinterpret_cast<const uint4*>(rec);
  const uint4 a = __ldg(v), b = __ldg(v + 1), c = __ldg(v + 2),
              d = __ldg(v + 3);
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
  wsh[0] = c.x; wsh[1] = c.y; wsh[2] = c.z; wsh[3] = c.w;
  wsh[4] = d.x; wsh[5] = d.y; wsh[6] = d.z; wsh[7] = d.w;
}

// Cooley-Tukey stages 0 .. u_end-1 of a pass: stage u pairs k with
// k + 8 / 2^(u+1).  Inputs below 2^32 - 2p; each stage adds less than 2p.
__device__ __forceinline__ void forward_stages(uint32_t (&x)[kRadix],
                                               const uint32_t (&w)[kRadix],
                                               const uint32_t (&wsh)[kRadix],
                                               int u_end, uint32_t p,
                                               uint32_t p2) {
#pragma unroll
  for (int u = 0; u < kLogRadix; ++u) {
    if (u < u_end) {
      const int half = kRadix >> (u + 1);
#pragma unroll
      for (int k = 0; k < kRadix; ++k) {
        if (k & half) continue;
        const int t = (1 << u) - 1 + (k >> (kLogRadix - u));
        const uint32_t v = shoup_lazy(x[k + half], w[t], wsh[t], p);
        x[k + half] = x[k] - v + p2;
        x[k] = x[k] + v;
      }
    }
  }
}

// Gentleman-Sande stages u_begin .. 2 of a pass: stage u pairs k with
// k + 2^u.  Inputs and outputs in [0, 2p).
__device__ __forceinline__ void inverse_stages(uint32_t (&x)[kRadix],
                                               const uint32_t (&w)[kRadix],
                                               const uint32_t (&wsh)[kRadix],
                                               int u_begin, uint32_t p,
                                               uint32_t p2) {
#pragma unroll
  for (int u = 0; u < kLogRadix; ++u) {
    if (u >= u_begin) {
      const int half = 1 << u;
#pragma unroll
      for (int k = 0; k < kRadix; ++k) {
        if (k & half) continue;
        const int t = kRadix - (kRadix >> u) + (k >> (u + 1));
        const uint32_t a = x[k], b = x[k + half];
        const uint32_t s = a + b;
        x[k] = min(s, s - p2);
        x[k + half] = shoup_lazy(a - b + p2, w[t], wsh[t], p);
      }
    }
  }
}

// The forward half of a prime's external product, by the CTA's N/8
// threads: the transforms of the digit polynomials i < NP for which
// slot(i) >= 0, each kept at buf polynomial slot(i) between passes, ending
// with the last pass (shift 0) in d[i]: thread tid holds spectral words
// tid * 8 ... tid * 8 + 7.  digit(i, k) gives the signed digit at word
// elem(tid, a0, k) = tid + k N/8 of polynomial i.  kLastInBuf also stores
// the last pass to buf (for another CTA to read).  On return offs holds the
// thread's offsets of shift 0.
template <int NP, bool kLastInBuf, typename Slot, typename Digit>
__device__ __forceinline__ void forward_transforms(
    uint32_t* buf, int N, const Plan& pl, const uint32_t* __restrict__ fwd,
    const PrimeConsts& c, Slot slot, Digit digit, uint32_t (&d)[NP][kRadix],
    int (&offs)[kRadix]) {
  const int tid = threadIdx.x;
  uint32_t w[kRadix], wsh[kRadix];
  // forward pass 0: the digits, mod p, at the words of shift a0
  int a = pl.fwd_shift(0);
  pass_offsets(tid, a, offs);
  load_record(fwd, w, wsh);
  int off = kRecord;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    if (slot(i) >= 0) {
#pragma unroll
      for (int k = 0; k < kRadix; ++k) d[i][k] = digit_mod(digit(i, k), c);
      forward_stages(d[i], w, wsh, pl.s0, c.p, c.p2);
      store_words(buf + slot(i) * N, a, offs, d[i]);
    }
  }
  // forward passes 1 .. passes-1; the last (shift 0) stays in registers
  for (int q = 1; q < pl.passes; ++q) {
    a = pl.fwd_shift(q);
    const bool last = q == pl.passes - 1;
    pass_offsets(tid, a, offs);
    __syncthreads();
    load_record(fwd + off + (tid >> a) * kRecord, w, wsh);
    off += (N >> (a + kLogRadix)) * kRecord;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      if (slot(i) >= 0) {
        load_words(buf + slot(i) * N, a, offs, d[i]);
        forward_stages(d[i], w, wsh, kLogRadix, c.p, c.p2);
        if (!last || kLastInBuf) store_words(buf + slot(i) * N, a, offs, d[i]);
      }
    }
  }
}

// The inverse half after inverse pass 0: output polynomials om = first,
// first + step, ... < count, each at buf polynomial om / step (written at
// shift 0 by the caller), through inverse passes 1 .. passes-1; the last
// (shift a0) calls emit(om, k, x) with the word at tid + k N/8, in [0, 2p).
template <typename Emit>
__device__ __forceinline__ void inverse_transforms(
    uint32_t* buf, int count, int first, int step, int N, const Plan& pl,
    const uint32_t* __restrict__ inv, const PrimeConsts& c, Emit emit) {
  const int tid = threadIdx.x;
  uint32_t w[kRadix], wsh[kRadix];
  int offs[kRadix];
  int off = (N >> kLogRadix) * kRecord;
  for (int iq = 1; iq < pl.passes; ++iq) {
    const int a = pl.fwd_shift(pl.passes - 1 - iq);
    const bool last = iq == pl.passes - 1;
    pass_offsets(tid, a, offs);
    __syncthreads();
    load_record(inv + off + (tid >> a) * kRecord, w, wsh);
    off += (N >> (a + kLogRadix)) * kRecord;
    for (int om = first; om < count; om += step) {
      uint32_t o[kRadix];
      load_words(buf + om / step * N, a, offs, o);
      inverse_stages(o, w, wsh, last ? kLogRadix - pl.s0 : 0, c.p, c.p2);
      if (last) {
#pragma unroll
        for (int k = 0; k < kRadix; ++k) emit(om, k, o[k]);
      } else {
        store_words(buf + om / step * N, a, offs, o);
      }
    }
  }
}

// One prime's external product of one ciphertext by the CTA's N/8 threads:
// the LJ digit polynomials' forward transforms, the MAC against the key
// block ks / ksh [LJ, OM, N] of this prime, and the OM inverse transforms,
// unscaled.  digit(lj, k) gives the signed digit at word elem(tid, a0, k)
// = tid + k N/8 of polynomial lj; emit(om, k, x) receives output om's word
// at that same position, in [0, 2p).  buf holds max(LJ, OM) polynomials.
// On entry no thread may still read buf at words other than its own of
// shift a0; on return every thread has read only its own words of shift
// a0 since its last barrier, so two calls may follow each other with no
// barrier between them.  LJ <= LJ_MAX.
//
// kParts = 2 splits the product over a cluster of two CTAs: CTA rank r
// transforms the digit polynomials lj = r, r + 2, ... (digit is asked for
// those only), the two exchange their spectra through distributed shared
// memory between two cluster barriers, and CTA r runs the MAC and inverse
// transforms of the outputs om = r, r + 2, ... (emitted for those only),
// output om in buf's polynomial om / 2.
template <int LJ_MAX, int kParts = 1, typename Digit, typename Emit>
__device__ __forceinline__ void external_product_prime(
    uint32_t* buf, int LJ, int OM, int N, const Plan& pl,
    const uint32_t* __restrict__ tab, const uint32_t* __restrict__ ks,
    const uint32_t* __restrict__ ksh, Digit digit, Emit emit) {
  static_assert(kParts == 1 || kParts == 2, "one CTA or a pair");
  const int tid = threadIdx.x;
  const int part =
      kParts == 1 ? 0 : (int)cooperative_groups::this_cluster().block_rank();
  const PrimeConsts c = load_consts(tab);
  const uint32_t* fwd = tab + kHeader;
  const uint32_t* inv = fwd + pl.words;
  uint32_t d[LJ_MAX][kRadix];
  uint32_t w[kRadix], wsh[kRadix];
  int offs[kRadix];
  forward_transforms<LJ_MAX, (kParts > 1)>(
      buf, N, pl, fwd, c,
      [&](int lj) { return lj < LJ && lj % kParts == part ? lj : -1; },
      digit, d, offs);
  if constexpr (kParts > 1) {
    const cooperative_groups::cluster_group cluster =
        cooperative_groups::this_cluster();
    cluster.sync();  // both CTAs' spectra are in their bufs
    const uint32_t* other = cluster.map_shared_rank(buf, part ^ 1);
#pragma unroll
    for (int lj = 0; lj < LJ_MAX; ++lj)
      if (lj < LJ && lj % kParts != part)
        load_words(other + lj * N, 0, offs, d[lj]);
    cluster.sync();  // the other CTA has read this one's spectra
  }

  // the MAC and inverse pass 0 (shift 0, the same words): no barrier
  load_record(inv + tid * kRecord, w, wsh);
  for (int om = part; om < OM; om += kParts) {
    uint32_t o[kRadix];
#pragma unroll
    for (int k = 0; k < kRadix; ++k) o[k] = 0;
#pragma unroll
    for (int lj = 0; lj < LJ_MAX; ++lj) {
      if (lj < LJ) {
        const long long at = ((long long)lj * OM + om) * N + tid * kRadix;
        const uint4* kv = reinterpret_cast<const uint4*>(ks + at);
        const uint4* sv = reinterpret_cast<const uint4*>(ksh + at);
        const uint4 k0 = __ldg(kv), k1 = __ldg(kv + 1);
        const uint4 s0 = __ldg(sv), s1 = __ldg(sv + 1);
        const uint32_t kk[kRadix] = {k0.x, k0.y, k0.z, k0.w,
                                     k1.x, k1.y, k1.z, k1.w};
        const uint32_t ss[kRadix] = {s0.x, s0.y, s0.z, s0.w,
                                     s1.x, s1.y, s1.z, s1.w};
#pragma unroll
        for (int k = 0; k < kRadix; ++k)
          o[k] += shoup_lazy(d[lj][k], kk[k], ss[k], c.p);
      }
    }
#pragma unroll
    for (int k = 0; k < kRadix; ++k)
      o[k] = shoup_lazy(o[k], 1u, c.one_sh, c.p);  // sum < 2 LJ p -> [0, 2p)
    inverse_stages(o, w, wsh, 0, c.p, c.p2);
    store_words(buf + om / kParts * N, 0, offs, o);
  }
  inverse_transforms(buf, OM, part, kParts, N, pl, inv, c, emit);
}

}  // namespace tfhe_core
