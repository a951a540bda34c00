// K8's combine stage for Hopper (sm_90a): the port's counterpart of the
// Pallas kernels of `tfhe_tpu/ops/fused_multibit.py` that write the
// per-ciphertext combined key in schedule "scan3":
//
//   multibit_combine_kernel  <- K8 singles_kernel (:747) + combine_kernel
//                               (:776) of fused_multibit_rotate_scan (:702)
//
// A scan3 group step is two launches: this kernel, then K8's external
// product from the accumulator, multibit_step_cluster_kernel<., true>
// (multibit_core.cuh: the digits, the MAC against the combined key and the
// CRT from zero in one cluster launch).  K9, schedule "scan1", runs the
// same kernel with the subsets combined inside its MAC instead.
//
// One group step of gf mask elements replaces the accumulator by the
// external product of the combined GGSW
//     K = K_0 + sum_{j >= 1} X^{d_j} K_j
// with the accumulator, where K_j is the key of subset j (bit gf-1-i of j
// selects mask element i) and d_j the switched subset sum.  The spectrum of
// X^d at position n is psi^(d * e(n) mod 2N) (ops/ntt.py), a gather from the
// table of the 2N powers of psi.  The TPU built composite monomials from
// products of singletons with an epsilon correction only because Mosaic
// has no gather; here every subset gathers its own.
//
// Layouts (all dense):
//   d         [B, per]              int32  d_j mod 2N, per = 2^gf subsets
//   kspec     [per, P, LJ, O, M, N] uint32 one group's subset key spectra
//   powers    [P, 2, 2N]            uint32 psi^k and Shoup companions
//   exps      [N]                   int32  e(n)
//   tables    [P, kHeader + 2 W]    uint32 ntt.pass_tables_for(N): the
//                                          header of prime pi (p, its
//                                          companions, 2^32 mod p)
//   combined  [B, P, LJ, O, M, N]   uint32 per-ciphertext combined key
//
// What bounds it on the card: by bytes, the write of the combined key, B P
// LJ O M N 4 bytes (128 KiB a ciphertext at
// PARAM_MULTI_BIT_MESSAGE_2_CARRY_2_GROUP_3_KS_PBS width on the key's four
// primes and one plane, 320 KiB on five and two); in fact its integer
// instruction rate, (2^gf - 1) products a word.
//
// First design: one thread per key word and 16 ciphertexts, every block
// first copying its prime's padded power table and companions (2 (2N + 32)
// words, 33 KB at N = 2048) into shared memory behind a barrier, 1280
// blocks at B = 64 (42 MB of table copies to write 20 MB), one gather per
// word, subset and ciphertext, scalar 4-byte loads and stores; 0.0573 ms at
// GROUP_3 width and B = 64 on an H100, 8.1x its bound.  Both layouts that
// hold a thread's 8 words as K9's thread does (K9's factorisation of the
// monomial, multibit_core.cuh: mon_j(n) = psi^(d_j e(8t)) w^m, m = d_j
// bitrev3(k) mod 8, w = psi^(N/4), w^(m + 4) = -w^m, so one gather a
// subset and ciphertext, then per word a Shoup product, a sign and at most
// one product by w, w^2 or w^3) stayed issue-bound at two Shoup products a
// word and subset: holding the subsets' key words in registers across 8
// ciphertexts, 0.0525 ms; holding the monomials across the rows, which
// reads every key word once a ciphertext, 0.0708.  Kept: a block holds a
// tile of kCombineRows key rows of every subset in shared memory for
// kCombineBatch ciphertexts (one a warp), and a thread, one ciphertext's 8
// words of each row, makes its monomial words once per subset and tile
// (one gather and three products for the four values psi^t w^s, then a
// choice and a sign per word) and sums the products with the canonical key
// words exactly in 64 bits, one multiply-add each, reduced once a word:
// 0.0307 ms (122 registers, two blocks an SM).  Tiles of 2 rows (more
// monomials made) ran 0.0393, of 8 rows (212 registers, one block an SM)
// 0.0320; capped at 80 registers for three blocks an SM, 0.0361 (100 bytes
// spilled) and, with tiles of 3 rows, 0.0327.  All at GROUP_3 width, B =
// 64, measured with kernel_times.py.  Then the key's primes: on its four
// below 2^26.83 and one plane (ntt.classic_plan for 2^gf summed words) a
// GROUP_3 key has R = 4 rows, one tile, and the sums need the core's
// 64-bit reduction (reduce_u64); 0.0116 ms at B = 64, 0.0390 at B = 256,
// against 0.0307 and 0.0880 on five primes and two planes (119
// registers).
#pragma once

#include <stdint.h>

#include "multibit_core.cuh"
#include "pbs_kernels.cuh"

namespace tfhe_pbs {

constexpr int kMaxSubsets = 16;     // 2^gf for gf <= 4
constexpr int kMaxOutputs = 8;      // O*M: G <= 4 output polynomials, 2 planes
                                    // (K9's limit)
constexpr int kCombineCols = 32;   // 8-word columns a block spans (a warp)
constexpr int kCombineBatch = 8;   // ciphertexts a block spans, one a warp
constexpr int kCombineRows = 4;    // key rows a shared-memory tile holds

using tfhe_core::kRadix;

// dynamic shared memory of multibit_combine_kernel: per subsets' tiles
inline size_t combine_smem(int per) {
  return (size_t)per * kCombineRows * kCombineCols * kRadix *
         sizeof(uint32_t);
}

// one prime's w^1, w^2, w^3 (w = psi^(N/4))
struct MonoConsts {
  uint32_t w1, w2, w3;
};

__device__ __forceinline__ MonoConsts load_mono_consts(
    const uint32_t* __restrict__ pw, int N) {
  MonoConsts r;
  r.w1 = __ldg(pw + (N >> 2));
  r.w2 = __ldg(pw + (N >> 1));
  r.w3 = __ldg(pw + 3 * (N >> 2));
  return r;
}

// The 16-byte slot of a tile row's vector v (64 a row): thread tx reads
// vectors 2 tx and 2 tx + 1, which would put two threads of a quarter warp
// on one bank group; swapping the pair for tx mod 8 >= 4 spreads them.
__device__ __forceinline__ int tile_slot(int v) { return v ^ ((v >> 3) & 1); }

// K8's combine: block (x, pi, z) holds, tile by tile, kCombineRows rows of
// the per subset keys of prime pi at the columns of its kCombineCols
// threads' words in shared memory; thread (tx, ty) owns ciphertext b = z
// kCombineBatch + ty and the words n0 ... n0 + 7, n0 = 8 (x kCombineCols +
// tx), of every row.  Per subset j >= 1 and tile it makes its 8 monomial
// words once: mon_j(n0 + k) = psi^(d_j e(n0)) w^m, m = d_j bitrev3(k) mod
// 8, from one gather (value and companion) and three Shoup products (the
// values psi^t w^s, s < 4; w^(s + 4) = -w^s), then sums K_0 + sum_j mon_j
// K_j over the tile's rows exactly in 64 bits, one multiply-add a product
// (canonical words below p < 2^26.83: at most p + 15 p^2 < 2^58), and
// brings each word canonical once (tfhe_core::reduce_u64, then one
// subtraction).  R = LJ O M rows of N words; of the core's tables
// (ntt.pass_tables_for) only each prime's header is read.
__global__ void __launch_bounds__(kCombineCols * kCombineBatch)
    multibit_combine_kernel(const int32_t* __restrict__ d,
                            const uint32_t* __restrict__ kspec,
                            const uint32_t* __restrict__ powers,
                            const int32_t* __restrict__ exps,
                            const uint32_t* __restrict__ tables,
                            uint32_t* __restrict__ combined, int B, int per,
                            int R, int N) {
  extern __shared__ uint4 combine_tile[];  // [per][kCombineRows][64]
  constexpr int kVecs = kCombineCols * kRadix / 4;  // 16-byte vectors a row
  const int pi = blockIdx.y;
  const int P = gridDim.y;
  const int tx = threadIdx.x;
  const int tid = threadIdx.y * kCombineCols + tx;
  const int n0 = (blockIdx.x * kCombineCols + tx) * kRadix;
  const int b = blockIdx.z * kCombineBatch + threadIdx.y;
  const uint32_t* pw = powers + (long long)pi * 4 * N;
  const MonoConsts r = load_mono_consts(pw, N);
  const uint32_t* tab =
      tables + (long long)pi * (tfhe_core::kHeader +
                                2 * tfhe_core::make_plan(__ffs(N) - 1).words);
  const tfhe_core::PrimeConsts pc = tfhe_core::load_consts(tab);
  const tfhe_core::WideConsts wc = tfhe_core::load_wide_consts(tab);
  const int e0 = __ldg(exps + n0);
  const long long W = (long long)R * N;  // one subset key, one prime
  const uint32_t* kp = kspec + (long long)pi * W +
                       blockIdx.x * kCombineCols * kRadix;
  const int tile_vecs = per * kCombineRows * kVecs;
  for (int r0 = 0; r0 < R; r0 += kCombineRows) {
    __syncthreads();  // every thread is done with the previous tile
    for (int i = tid; i < tile_vecs; i += kCombineCols * kCombineBatch) {
      const int v = i % kVecs;
      const int jr = i / kVecs;  // j kCombineRows + row
      const int row = r0 + jr % kCombineRows;
      if (row < R)
        combine_tile[i - v + tile_slot(v)] = __ldg(
            reinterpret_cast<const uint4*>(
                kp + ((long long)(jr / kCombineRows) * P * R + row) * N) +
            v);
    }
    __syncthreads();  // the tile is in place
    if (b >= B) continue;
    const uint4* mine = combine_tile + tile_slot(2 * tx);
    const uint4* mine2 = combine_tile + tile_slot(2 * tx + 1);
    uint64_t o[kCombineRows][kRadix];
#pragma unroll
    for (int q = 0; q < kCombineRows; ++q) {
      const uint4 a = mine[q * kVecs], c = mine2[q * kVecs];
      const uint32_t k0[kRadix] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
#pragma unroll
      for (int k = 0; k < kRadix; ++k) o[q][k] = k0[k];
    }
    for (int j = 1; j < per; ++j) {
      const int dj = __ldg(d + (long long)b * per + j);
      const int t = (dj * e0) & (2 * N - 1);
      const uint32_t v0 = __ldg(pw + t), v0sh = __ldg(pw + 2 * N + t);
      const uint32_t v1 = tfhe_core::shoup_canonical(r.w1, v0, v0sh, pc.p);
      const uint32_t v2 = tfhe_core::shoup_canonical(r.w2, v0, v0sh, pc.p);
      const uint32_t v3 = tfhe_core::shoup_canonical(r.w3, v0, v0sh, pc.p);
      uint32_t mon[kRadix];
#pragma unroll
      for (int k = 0; k < kRadix; ++k) {
        const int m = (dj * tfhe_core::bitrev3(k)) & 7;
        const uint32_t v = (m & 2) ? ((m & 1) ? v3 : v2) : ((m & 1) ? v1 : v0);
        mon[k] = m & 4 ? pc.p - v : v;  // psi^t is never 0
      }
      const int at = j * kCombineRows * kVecs;
#pragma unroll
      for (int q = 0; q < kCombineRows; ++q) {
        const uint4 a = mine[at + q * kVecs], c = mine2[at + q * kVecs];
        const uint32_t kj[kRadix] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
#pragma unroll
        for (int k = 0; k < kRadix; ++k) o[q][k] += (uint64_t)kj[k] * mon[k];
      }
    }
    uint32_t* out = combined + ((long long)b * P + pi) * W + n0;
#pragma unroll
    for (int q = 0; q < kCombineRows; ++q) {
      if (r0 + q < R) {
        uint32_t c[kRadix];
#pragma unroll
        for (int k = 0; k < kRadix; ++k) {
          const uint32_t x = tfhe_core::reduce_u64(o[q][k], pc, wc);
          c[k] = min(x, x - pc.p);
        }
        const uint4 lo = make_uint4(c[0], c[1], c[2], c[3]);
        const uint4 hi = make_uint4(c[4], c[5], c[6], c[7]);
        reinterpret_cast<uint4*>(out + (long long)(r0 + q) * N)[0] = lo;
        reinterpret_cast<uint4*>(out + (long long)(r0 + q) * N)[1] = hi;
      }
    }
  }
}

}  // namespace tfhe_pbs
