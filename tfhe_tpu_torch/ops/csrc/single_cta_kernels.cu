// Plain C entry points for the kernels that hold a step's accumulator on
// chip, on the register-resident core (ntt_core_kernels.cuh), loaded by
// tfhe_tpu_torch/ops/fused_pbs.py with ctypes, on the tables
// ntt.pass_tables_for(N):
//
//   tfhe_blind_rotate_single_cta    K7 (mega), all n steps in one launch:
//                                   blind_rotate_core_kernel or
//                                   blind_rotate_cluster_core_kernel
//   tfhe_pbs_step_single_cta        K4 (scan1w) and K3 (scan1), one
//                                   step: pbs_step_cluster_kernel or
//                                   blind_rotate_core_kernel over one step
//   tfhe_blind_rotate_persistent    K5 (grid), all n steps in one launch:
//                                   blind_rotate_stream_cluster_kernel
//
// and *_form, which say which kernel a batch gets, and
// tfhe_blind_rotate_persistent_clusters, how many of K5's clusters the
// device holds at once.  As in pbs_kernels.cu
// the launches go on the caller's stream, do not synchronise, allocate
// nothing, and return cudaGetLastError() (0 on success).  A layout beyond
// the kernels' limits (LJ beyond tfhe_core::kMaxDigitPolys, N outside
// 256 ... 2048, more than kMaxPrimes primes, or more shared memory than
// the device allows a block) launches nothing and returns
// cudaErrorInvalidValue.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libsingle_cta_kernels.so single_cta_kernels.cu
#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>

#include "core_launch.cuh"

namespace {

using tfhe_core::allow_smem;
using tfhe_core::by_digit_polys;
using tfhe_core::cluster_config;
using tfhe_core::launch_clusters;
using tfhe_core::log2_int;

// K7 on the register-resident core: blind_rotate_core_kernel (a CTA per
// ciphertext, the primes in turn) or blind_rotate_cluster_core_kernel (a
// cluster of P CTAs per ciphertext, one prime each), whichever should
// finish first.  A launch runs in waves of the CTAs (clusters) that fit on
// the device at once, and a cluster's wave takes about 1 / (0.7 P) of a
// single-CTA wave: on an H100 (132 SMs), 17.2 against 50.6 ms at
// PARAM_MESSAGE_2_CARRY_2_KS_PBS width (742 steps) and 22.2 against 89.4
// ms at boolean DEFAULT_PARAMETERS width (722 steps), B = 64
// (kernel_times.py).  So the clusters run when ceil(B / clusters that fit)
// < 0.7 P ceil(B / CTAs that fit): at B = 64 at both widths, and at
// B = 256 for boolean (3 waves of 105 clusters) but not for shortint (5
// waves of 52 clusters against one of 264 CTAs).

// The core's limits, and the shared memory of K7's two forms: the
// accumulator, the digits and the exchange buffer; the single CTA keeps
// the explicit CRT's fractions besides.  A size beyond the device's limit
// is refused when the form is picked (allow_smem).
int core_layout(int G, int M, int P, int N, int levels, size_t* smem,
                size_t* cluster_smem) {
  const int LJ = levels * G, OM = G * M;
  const int err = tfhe_core::core_refuses(LJ, N, P);
  if (err) return err;
  *cluster_smem = (size_t)G * N * sizeof(uint64_t) +
                  (size_t)LJ * N * sizeof(uint32_t) +
                  tfhe_core::product_smem(LJ, OM, N);
  *smem = *cluster_smem + (size_t)OM * N * sizeof(uint32_t);
  return 0;
}

// *cluster = 1 if a batch of B runs as `split` (a cluster of P CTAs per
// ciphertext, cluster_smem bytes a CTA), 0 as `single` (a CTA per
// ciphertext, smem bytes), by the rule above.  The answer is cached per
// kernels, device, B, N and sizes, so the host asks the occupancy API once.
template <class Single, class Split>
int pick_form(Single single, Split split, int B, int P, int N, size_t smem,
              size_t cluster_smem, int* cluster) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, const void*, int, int, int, int,
                             size_t, size_t>,
                  int>
      known;
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  const auto key = std::make_tuple((const void*)single, (const void*)split,
                                   dev, B, P, N, smem, cluster_smem);
  {
    std::lock_guard<std::mutex> lock(mu);
    const auto it = known.find(key);
    if (it != known.end()) {
      *cluster = it->second;
      return 0;
    }
  }
  err = allow_smem((const void*)single, smem);
  if (!err) err = allow_smem((const void*)split, cluster_smem);
  if (err) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t config =
      cluster_config(B, P, N, cluster_smem, 0, attr);
  int sms = 0, per_sm = 0, clusters = 0;
  err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev);
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, single, N / tfhe_core::kRadix, smem);
  if (!err)
    err = (int)cudaOccupancyMaxActiveClusters(&clusters, split, &config);
  if (err) return err;
  const long long waves_single =
      per_sm > 0 ? (B + (long long)per_sm * sms - 1) / ((long long)per_sm * sms)
                 : -1;
  const long long waves_split = clusters > 0 ? (B + clusters - 1) / clusters
                                             : -1;
  *cluster = waves_split > 0 && (waves_single < 0 ||
                                 10 * waves_split < 7 * P * waves_single);
  std::lock_guard<std::mutex> lock(mu);
  known[key] = *cluster;
  return 0;
}

// K7's two forms, and K4's: its own cluster kernel, or K7's single CTA
// over one step.  K4's cluster holds max(LJ, OM) + LJ polynomials a CTA.
template <int LJ_MAX>
int pick_rotation_form(int B, int P, int N, size_t smem, size_t cluster_smem,
                       int* cluster) {
  return pick_form(tfhe_core::blind_rotate_core_kernel<LJ_MAX>,
                   tfhe_core::blind_rotate_cluster_core_kernel<LJ_MAX>, B, P,
                   N, smem, cluster_smem, cluster);
}

size_t step_cluster_smem(int G, int M, int N, int levels) {
  const int LJ = levels * G;
  return tfhe_core::product_smem(LJ, G * M, N) +
         (size_t)LJ * N * sizeof(uint32_t);
}

template <int LJ_MAX>
int pick_step_form(int B, int G, int M, int P, int N, int levels,
                   size_t smem, int* cluster) {
  return pick_form(tfhe_core::blind_rotate_core_kernel<LJ_MAX>,
                   tfhe_core::pbs_step_cluster_kernel<LJ_MAX>, B, P, N, smem,
                   step_cluster_smem(G, M, N, levels), cluster);
}

template <int LJ_MAX>
int launch_single(const void* acc_in, const void* ahat, const void* kspec,
                  const void* kshoup, const void* tables, const void* xcrt,
                  void* acc_out, int B, int n_steps, int G, int M, int P,
                  int N, int base_log, int levels, int bits, size_t smem,
                  cudaStream_t st) {
  return tfhe_core::launch_ctas(
      tfhe_core::blind_rotate_core_kernel<LJ_MAX>, B, N, smem, st,
      (const int64_t*)acc_in, (const int32_t*)ahat, (const uint32_t*)kspec,
      (const uint32_t*)kshoup, (const uint32_t*)tables, (const int64_t*)xcrt,
      (int64_t*)acc_out, B, n_steps, G, M, P, N, log2_int(N), base_log,
      levels, bits);
}

template <int LJ_MAX>
int launch_core_as(const void* acc_in, const void* ahat, const void* kspec,
                   const void* kshoup, const void* tables, const void* xcrt,
                   void* acc_out, int B, int n_steps, int G, int M, int P,
                   int N, int base_log, int levels, int bits, size_t smem,
                   size_t cluster_smem, cudaStream_t st) {
  int cluster = 0;
  const int err =
      pick_rotation_form<LJ_MAX>(B, P, N, smem, cluster_smem, &cluster);
  if (err) return err;
  if (cluster)
    return launch_clusters(
        tfhe_core::blind_rotate_cluster_core_kernel<LJ_MAX>, B, P, N,
        cluster_smem, st, (const int64_t*)acc_in, (const int32_t*)ahat,
        (const uint32_t*)kspec, (const uint32_t*)kshoup,
        (const uint32_t*)tables, (const int64_t*)xcrt, (int64_t*)acc_out, B,
        n_steps, G, M, N, log2_int(N), base_log, levels, bits);
  return launch_single<LJ_MAX>(acc_in, ahat, kspec, kshoup, tables, xcrt,
                               acc_out, B, n_steps, G, M, P, N, base_log,
                               levels, bits, smem, st);
}

}  // namespace

extern "C" int tfhe_blind_rotate_single_cta(
    const void* acc_in, const void* ahat, const void* kspec,
    const void* kshoup, const void* tables, const void* xcrt, void* acc_out,
    int B, int n_steps, int G, int M, int P, int N, int base_log, int levels,
    int bits, void* stream) {
  size_t smem = 0, cluster_smem = 0;
  const int err = core_layout(G, M, P, N, levels, &smem, &cluster_smem);
  if (err) return err;
  return by_digit_polys(levels * G, [&](auto lj_max) {
    return launch_core_as<decltype(lj_max)::value>(
        acc_in, ahat, kspec, kshoup, tables, xcrt, acc_out, B, n_steps, G, M,
        P, N, base_log, levels, bits, smem, cluster_smem,
        (cudaStream_t)stream);
  });
}

// *cluster = 1 if K7 runs a batch of B as
// blind_rotate_cluster_core_kernel, 0 if as blind_rotate_core_kernel;
// cudaErrorInvalidValue for a layout the core refuses.
extern "C" int tfhe_blind_rotate_single_cta_form(int B, int G, int M, int P,
                                                 int N, int levels,
                                                 int* cluster) {
  size_t smem = 0, cluster_smem = 0;
  const int err = core_layout(G, M, P, N, levels, &smem, &cluster_smem);
  if (err) return err;
  return by_digit_polys(levels * G, [&](auto lj_max) {
    return pick_rotation_form<decltype(lj_max)::value>(B, P, N, smem,
                                                       cluster_smem, cluster);
  });
}

// K4: one step, acc, out [B, G, N], ahat [B], kspec / kshoup [P, LJ, G, M,
// N]: pbs_step_cluster_kernel, or blind_rotate_core_kernel over one step
// where the rule above prefers one CTA per ciphertext.
extern "C" int tfhe_pbs_step_single_cta(
    const void* acc, const void* ahat, const void* kspec, const void* kshoup,
    const void* tables, const void* xcrt, void* out, int B, int G, int M,
    int P, int N, int base_log, int levels, int bits, void* stream) {
  size_t smem = 0, rotation_cluster_smem = 0;
  const int err =
      core_layout(G, M, P, N, levels, &smem, &rotation_cluster_smem);
  if (err) return err;
  const cudaStream_t st = (cudaStream_t)stream;
  return by_digit_polys(levels * G, [&](auto lj_max) {
    constexpr int kLJ = decltype(lj_max)::value;
    int cluster = 0;
    const int e = pick_step_form<kLJ>(B, G, M, P, N, levels, smem, &cluster);
    if (e) return e;
    if (cluster)
      return launch_clusters(
          tfhe_core::pbs_step_cluster_kernel<kLJ>, B, P, N,
          step_cluster_smem(G, M, N, levels), st, (const int64_t*)acc,
          (const int32_t*)ahat, (const uint32_t*)kspec,
          (const uint32_t*)kshoup, (const uint32_t*)tables,
          (const int64_t*)xcrt, (int64_t*)out, levels * G, G, M, N,
          log2_int(N), base_log, levels, bits);
    return launch_single<kLJ>(acc, ahat, kspec, kshoup, tables, xcrt, out, B,
                              1, G, M, P, N, base_log, levels, bits, smem, st);
  });
}

// *cluster = 1 if K4 runs a batch of B as pbs_step_cluster_kernel, 0 if as
// blind_rotate_core_kernel over one step.
extern "C" int tfhe_pbs_step_single_cta_form(int B, int G, int M, int P,
                                             int N, int levels,
                                             int* cluster) {
  size_t smem = 0, rotation_cluster_smem = 0;
  const int err =
      core_layout(G, M, P, N, levels, &smem, &rotation_cluster_smem);
  if (err) return err;
  return by_digit_polys(levels * G, [&](auto lj_max) {
    return pick_step_form<decltype(lj_max)::value>(B, G, M, P, N, levels,
                                                   smem, cluster);
  });
}

// K5: n_steps steps in one launch, acc_in, acc_out [B, G, N] (not
// aliased), ahat [n_steps, B], kspec / kshoup [n_steps, P, LJ, G, M, N]:
// blind_rotate_stream_cluster_kernel, always the cluster form (the grid
// schedule: one cluster per ciphertext at every B; K7 is the one-CTA form),
// with K4's cluster shared memory.
extern "C" int tfhe_blind_rotate_persistent(
    const void* acc_in, const void* ahat, const void* kspec,
    const void* kshoup, const void* tables, const void* xcrt, void* acc_out,
    int B, int n_steps, int G, int M, int P, int N, int base_log, int levels,
    int bits, void* stream) {
  const int err = tfhe_core::core_refuses(levels * G, N, P);
  if (err) return err;
  const size_t smem = step_cluster_smem(G, M, N, levels);
  return by_digit_polys(levels * G, [&](auto lj_max) {
    return launch_clusters(
        tfhe_core::blind_rotate_stream_cluster_kernel<decltype(lj_max)::value>,
        B, P, N, smem, (cudaStream_t)stream, (const int64_t*)acc_in,
        (const int32_t*)ahat, (const uint32_t*)kspec,
        (const uint32_t*)kshoup, (const uint32_t*)tables,
        (const int64_t*)xcrt, (int64_t*)acc_out, B, n_steps, G, M, N,
        log2_int(N), base_log, levels, bits);
  });
}

// *clusters = how many of K5's clusters the current device holds at once
// for a batch of B (cudaOccupancyMaxActiveClusters, as pick_form asks it):
// the batch runs in ceil(B / *clusters) waves of whole rotations.
extern "C" int tfhe_blind_rotate_persistent_clusters(int B, int G, int M,
                                                     int P, int N,
                                                     int levels,
                                                     int* clusters) {
  const int err = tfhe_core::core_refuses(levels * G, N, P);
  if (err) return err;
  const size_t smem = step_cluster_smem(G, M, N, levels);
  return by_digit_polys(levels * G, [&](auto lj_max) {
    const auto kernel =
        tfhe_core::blind_rotate_stream_cluster_kernel<decltype(lj_max)::value>;
    int e = allow_smem((const void*)kernel, smem);
    if (e) return e;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t config = cluster_config(B, P, N, smem, 0, attr);
    return (int)cudaOccupancyMaxActiveClusters(clusters, kernel, &config);
  });
}
