// Whole blind-rotation steps on one thread-block cluster per ciphertext, for
// Hopper (sm_90a): the port's counterpart of two TPU schedules of
// `tfhe_tpu/ops/fused_pbs.py`.
//
//   blind_rotate_cluster_kernel, one step per launch
//       <- fused_blind_rotate_scan1 (:1281) -> step_kernel (:1304)   (K3)
//   blind_rotate_cluster_kernel, all n steps in one launch
//       <- fused_blind_rotate_grid (:1341) -> _make_grid_kernel (:1020) (K5)
//
// A cluster of P CTAs owns one ciphertext, one CTA per prime.  Each CTA
// holds its own copy of the accumulator [G, N] in shared memory.  A step
// (cluster_pbs_step, the body both schedules share):
//   1. every CTA rotates its copy by X^{a_i}, subtracts, decomposes, and
//      reduces the digits mod its own prime (rotate_decompose's math);
//   2. every CTA runs its prime's forward NTTs, the MAC against the step's
//      key spectra with Shoup products and the inverse NTTs (ntt_mac's
//      math), and scales by N^-1: its residues stay in its shared memory;
//   3. after a cluster barrier, each CTA takes 1/P of the coefficients,
//      reads their P residues through distributed shared memory, runs
//      Garner's CRT, adds to the accumulator and writes the new word into
//      every CTA's copy; a second barrier ends the step.
// The accumulator never leaves the cluster between steps; per step device
// memory sees only the key slice [P, LJ, O, M, N] (shared by every
// ciphertext, so mostly from L2).  Residues never reach device memory.
//
// Layouts are those of pbs_kernels.cuh:
//   acc_in, acc_out [B, G, N] int64; ahat [n, B] int32 in [0, 2N];
//   kspec, kshoup [n, P, LJ, O, M, N] uint32; tables [P, 5, N]; crt [P, 2P+4].
// Shared memory per CTA: G*N*8 + (LJ + O*M)*N*4 bytes (36 KB at boolean
// DEFAULT_PARAMETERS, 80 KB at PARAM_MESSAGE_2_CARRY_2_KS_PBS).
//
// What bounds it on the card: integer issue in the NTTs, as K2; the
// schedule removes K2's residue round trip, the digits' and accumulator's
// trips through device memory and, in the persistent form, every launch
// but one.  The clusters are independent (no grid-wide barrier), so a batch
// larger than the card holds at once runs in waves.
#pragma once

#include <cooperative_groups.h>
#include <stdint.h>

#include "pbs_kernels.cuh"

namespace tfhe_pbs {

namespace cg = cooperative_groups;

// One step of the blind rotation of this cluster's ciphertext; `a` is the
// modulus-switched mask element in [0, 2N).  On entry every CTA's acc holds
// the accumulator; on return it holds acc + GGSW (x) (acc * X^a - acc).
__device__ __forceinline__ void cluster_pbs_step(
    cg::cluster_group& cluster, int64_t* acc, uint32_t* dsp, uint32_t* osp,
    int a, const uint32_t* __restrict__ kspec,
    const uint32_t* __restrict__ kshoup, const uint32_t* __restrict__ tables,
    const int64_t* __restrict__ crt, int G, int M, int N, int log_n,
    int base_log, int levels, int bits) {
  const int P = (int)cluster.num_blocks();
  const int pi = (int)cluster.block_rank();
  const int LJ = levels * G;
  const int OM = G * M;
  const uint32_t* tab = tables + (long long)pi * 5 * N;
  const uint32_t ninv = tab[4 * N];
  const uint32_t ninv_sh = tab[4 * N + 1];
  const uint32_t p = tab[4 * N + 2];
  const uint64_t mask = bits == 64 ? ~0ull : 0xFFFFFFFFull;

  // 1. the digits of acc * X^a - acc, mod this CTA's prime
  for (int idx = threadIdx.x; idx < G * N; idx += blockDim.x) {
    const int g = idx >> log_n;
    const int j = idx & (N - 1);
    decompose_word(rotated_diff(acc + g * N, a, j, N, mask), base_log, levels,
                   bits, mask, [&](int lvl, int32_t digit) {
                     const int32_t r = digit % (int32_t)p;
                     dsp[(lvl * G + g) * N + j] =
                         (uint32_t)(r < 0 ? r + (int32_t)p : r);
                   });
  }
  __syncthreads();

  // 2. this prime's external product; its residues stay in osp
  const long long kblock = (long long)pi * LJ * OM * N;
  ntt_mac_smem<false>(dsp, osp, kspec + kblock, kshoup + kblock, tab, LJ, OM,
                      N, log_n);
  for (int idx = threadIdx.x; idx < OM * N; idx += blockDim.x)
    osp[idx] = mul_shoup(osp[idx], ninv, ninv_sh, p);
  // every prime's residues are ready, and every CTA has read its acc
  cluster.sync();

  // 3. Garner's CRT over this CTA's share of the coefficients, the new
  // words written into every CTA's accumulator
  const uint32_t* res[kMaxPrimes];
  int64_t* accs[kMaxPrimes];
  for (int i = 0; i < P; ++i) {
    res[i] = cluster.map_shared_rank(osp, i);
    accs[i] = cluster.map_shared_rank(acc, i);
  }
  const int share = (G * N + P - 1) / P;
  const int end = min(G * N, (pi + 1) * share);
  for (int idx = pi * share + threadIdx.x; idx < end; idx += blockDim.x) {
    const int o = idx >> log_n;
    const int n = idx & (N - 1);
    uint64_t total = (uint64_t)acc[idx];
    for (int m = 0; m < M; ++m) {
      const int at = (o * M + m) * N + n;
      const uint64_t x = garner([&](int i) { return res[i][at]; }, crt, P);
      total += m == 0 ? x : (x << 32);
    }
    total &= mask;
    for (int i = 0; i < P; ++i) accs[i][idx] = (int64_t)total;
  }
  // the new accumulator is in every CTA, and the residues are consumed
  cluster.sync();
}

// n_steps steps of the blind rotation; cluster c = blockIdx.x / P owns
// ciphertext c.  kspec / kshoup hold the n_steps steps' keys and ahat their
// [n_steps, B] mask elements.  acc_out may not alias acc_in.
__global__ void blind_rotate_cluster_kernel(
    const int64_t* __restrict__ acc_in, const int32_t* __restrict__ ahat,
    const uint32_t* __restrict__ kspec, const uint32_t* __restrict__ kshoup,
    const uint32_t* __restrict__ tables, const int64_t* __restrict__ crt,
    int64_t* __restrict__ acc_out, int B, int n_steps, int G, int M, int N,
    int log_n, int base_log, int levels, int bits) {
  extern __shared__ __align__(16) unsigned char step_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int P = (int)cluster.num_blocks();
  const int pi = (int)cluster.block_rank();
  const long long b = blockIdx.x / P;
  const int LJ = levels * G;
  int64_t* acc = (int64_t*)step_smem;           // [G, N]
  uint32_t* dsp = (uint32_t*)(acc + G * N);     // [LJ, N] digit spectra
  uint32_t* osp = dsp + LJ * N;                 // [O*M, N] residues

  const int64_t* src = acc_in + b * G * N;
  for (int idx = threadIdx.x; idx < G * N; idx += blockDim.x)
    acc[idx] = src[idx];
  __syncthreads();

  const long long step_words = (long long)P * LJ * G * M * N;
  for (int s = 0; s < n_steps; ++s) {
    const int a = ahat[(long long)s * B + b] & (2 * N - 1);  // 2N is 0
    cluster_pbs_step(cluster, acc, dsp, osp, a, kspec + s * step_words,
                     kshoup + s * step_words, tables, crt, G, M, N, log_n,
                     base_log, levels, bits);
  }

  const int share = (G * N + P - 1) / P;
  const int end = min(G * N, (pi + 1) * share);
  int64_t* dst = acc_out + b * G * N;
  for (int idx = pi * share + threadIdx.x; idx < end; idx += blockDim.x)
    dst[idx] = acc[idx];
}

}  // namespace tfhe_pbs
