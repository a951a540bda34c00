"""Drive tfhe_tpu_torch on one NVIDIA card: build, check, run, time.

    python3 chip_smoke.py

Phases, each printing one flushed line with its wall time:
  1. card: the card's name and power limit (nvidia-smi) and torch's name;
  2. build: nvcc builds the classic, the single-CTA (K3, K4, K5, K7), the
     multi-bit and the Shoup MAC kernels' libraries and g++ the native AES
     generator, from the sources in this checkout, all five at once;
  3. kernels_modes: every classic-schedule wrapper (K1, K2, pbs_step,
     blind_rotate_persistent, ntt_mac_prime, crt_accumulate, and
     pbs_step_single_cta, blind_rotate_single_cta) against its plain
     PyTorch version at the widths of PARAM_MESSAGE_2_CARRY_2_KS_PBS (N=2048,
     G=2, L=1, base_log 23, u64) and of boolean DEFAULT_PARAMETERS (N=512,
     G=3, L=3, base_log 6, u32), 5 primes, B=64, one step each, the
     persistent (K5) and single-CTA (K7) rotations at their main path's
     depth (742 and 722 steps) at B=64 and B=256 (each batch naming the K7
     kernel that ran it, one CTA or a cluster per ciphertext, and the
     clusters K5's kernel holds on the card at once and its waves), K3, K4 and
     ntt_mac_prime at B=256 too (K4 naming the kernel that K3 and K4 run
     for each batch), and a
     4-step rotation in every mode, bit-exact (tolerance 0), with device,
     eager and plain times per launch and bounds;
  4. main path: PARAM_MESSAGE_2_CARRY_2_KS_PBS keys generated on the card,
     64 messages covering all 16 message+carry values, three univariate LUTs
     and one bivariate LUT through the ServerKey entry points, every result
     decrypted and checked; then core.keyswitch_then_pbs on the same 64
     messages in each of the six modes (scan2, scan1, scan1w, scan3, grid,
     mega), identical and decrypted right, with exact launch counts per
     mode; then the same pipeline on a small insecure parameter set, on the
     card and on the CPU, bit-identical; then main_path_shortint_ops on the
     same keys (every bivariate op family's LUT over the 16 clean pairs in
     one many-LUT PBS batch, the neg / sub / scalar / trivial / extract
     batches over the 16 values, each op family through the one-block API,
     the `_clean` path at a saturated carry, checked_add refusing; the
     many-LUT batch again in scan1w and mega, identical), and
     main_path_pbs_ks (PARAM_MESSAGE_2_CARRY_2_COMPACT_PK_PBS_KS keys on
     the card, ciphertexts under the small key, PBS then keyswitch, three
     univariate and one bivariate LUT on 64 messages) with
     card_vs_cpu_both_orders (both PBS orders, classic and multi-bit, on
     small copies of the test sets, bit-identical);
  5. timing: keyswitch_then_pbs throughput at B=64 and B=256 in each mode
     (host clock, launch overhead included), its split into keyswitch and
     blind rotation, the PBS_KS set's pbs_then_keyswitch throughput in
     scan2, and K1/K2's device time per launch at B=256;
  6. kernels_multibit (run first, before phase 3): the three multi-bit
     kernels (K8's two stages, multibit_combine and
     multibit_external_product from the accumulator, and K9's
     multibit_step) against their plain versions at
     PARAM_MULTI_BIT_MESSAGE_2_CARRY_2_GROUP_3_KS_PBS's width (N=2048, G=2,
     L=1, base_log 21, gf=3 so 8 subset keys per group, B=64), one step each
     (and at B=256) and a 2-group blind rotation in both schedules,
     bit-exact, with times per launch;
  7. main_path_multibit: GROUP_3 keys generated on the card, the same 64
     messages through three univariate LUTs and one bivariate LUT with the
     ServerKey entry points (the default schedule, scan3, 296 group steps
     of two launches: multibit_combine, multibit_external_product),
     then the same four evaluations through core.keyswitch_then_multi_bit_pbs
     in the scan1 schedule (one K9 launch a group step), equal bit for bit,
     every result decrypted and checked, launches counted per schedule;
  8. card_vs_cpu_multibit: the multi-bit pipeline on the small insecure
     multi-bit set, on the card and on the CPU, bit-identical;
  9. timing_multibit: keyswitch_then_multi_bit_pbs throughput at B=64 and
     B=256 in both schedules, its split, and at B=256 the kernels' times
     and a whole group step's in each schedule;
 10. main_path_boolean: boolean DEFAULT_PARAMETERS keys generated on the
     card (n=722, N=512, k=2, u32, PBS then keyswitch), every gate and mux
     on 64 seeded bit pairs and triples through boolean.ServerKey in each of
     the six modes, every decryption equal to the clear gate, identical
     ciphertexts across modes, exact launch counts per blind rotation
     (scan2: n of K1 and of K2; scan1, scan1w: n (K3 and K4 run one kernel
     on the card, each counted as its own); scan3: n(P+2); grid, mega: 1);
 11. card_vs_cpu_boolean: BOOLEAN_TEST_PARAMETERS gates on the card in
     every mode, bit-identical to the CPU's plain versions;
 12. timing_boolean: gates/s and batch ms per mode at B=64 and B=256, split
     into blind rotation, sample extract and keyswitch;
 13. kernels_ntt (run after phase 3): K10 against its plain versions at
     the widths of the CRT-NTT key layout's three paths (shortint LJ=2,
     GM=4, N=2048; boolean 9, 3, 512; u128 2, 8, 2048), B=64, bit-exact,
     through both wrappers: `shoup_mac` for every prime (one launch each)
     and `shoup_mac_primes` (every prime of a step in one launch, the
     main paths' call), with device, eager and plain times and bounds of a
     step;
 14. main_path_ntt: mode="ntt" (the CRT-NTT layout, one K10 launch a step)
     at full width: PARAM_MESSAGE_2_CARRY_2_KS_PBS keys on the card, two
     LUTs on 64 messages, and boolean DEFAULT_PARAMETERS, every gate and mux
     on 64 seeded bits; decrypted right, word for word equal to scan2 keys
     rebuilt from the same raw keys, K10 launched exactly n times per PBS
     batch and nothing else launched;
 15. main_path_u128: the u128 PBS at the PBS widths and noise of
     PARAM_MESSAGE_2_CARRY_2_KS_PBS (n=742, N=2048, k=1, base_log 23, one
     level): keygen on the card, the identity and (3x+1) mod 4 LUTs on 64
     encryptions, all decrypted right, n K10 launches per rotation;
 16. card_vs_cpu_ntt: mode="ntt" shortint and boolean at the TEST sets and
     the u128 PBS at tests/test_u128.py's toy size, card == CPU word for
     word (keys, ciphertexts, outputs);
 17. timing_ntt: PBS/s (gates/s) and batch ms at B=64 and B=256 for
     shortint mode="ntt", the u128 PBS and boolean mode="ntt", and a
     CUDA-event split of one step into decomposition, forward NTT, K10 (one
     launch), inverse NTT and CRT.
Kernel times are device times: a CUDA graph of many launches replayed
between CUDA events (a whole rotation, persistent or single-CTA: CUDA events
around a few eager launches); the eager per-launch times beside them include
the host's launch cost.
Then a `kernels` JSON line (each kernel's `redesigned` names the source
it was rebuilt on after its first port: K2, K3, K4, K5, ntt_mac_prime, K7
and K9 on the register-resident NTT core, K10 in its own file; null for
the others), the nvidia-smi
line, and as the last line {"ok": true, "device": {...}}.  Any failed phase
raises, so the script exits non-zero and prints no result; it needs a card
and refuses to run without one.  A watchdog ends a hung run with a
traceback.
"""

import dataclasses
import faulthandler
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

WATCHDOG_S = 600
SEED = 2024
B_MAIN = 64
B_LARGE = 256

# H100 SXM peaks (NVIDIA data sheet):
# 3.35 TB/s HBM3, and 67 T 32-bit operations/s outside the tensor cores,
# the rate the integer arithmetic of these kernels is held against.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

# kernels rebuilt for Hopper after their first port, and the source they
# were rebuilt on: K2, K3 (on K4's kernel), K4, K5 (K4's step looped), K6's
# ntt_mac_prime, K7, K8's external product (on K9's kernel) and K9 on the
# register-resident NTT core; K10 (one launch a step for every prime), K8's
# combine (a key tile in shared memory) and K1 (4 words a thread) in their
# own files
REDESIGNED = dict.fromkeys(("external_product_crt", "pbs_step",
                            "pbs_step_single_cta", "blind_rotate_persistent",
                            "ntt_mac_prime", "blind_rotate_single_cta",
                            "multibit_external_product", "multibit_step"),
                           "tfhe_tpu_torch/ops/csrc/ntt_core.cuh")
REDESIGNED["shoup_mac"] = "tfhe_tpu_torch/ops/csrc/shoup_mac_kernels.cuh"
REDESIGNED["multibit_combine"] = (
    "tfhe_tpu_torch/ops/csrc/multibit_kernels.cuh")
REDESIGNED["rotate_decompose"] = "tfhe_tpu_torch/ops/csrc/pbs_kernels.cuh"


def say(phase, t0, **fields):
    print(json.dumps({"phase": phase, "wall_s": round(time.time() - t0, 3),
                      **fields}), flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters, warmup=2):
    """Mean time per call of fn() in ms, by CUDA events around `iters`
    eager calls: the host's launch cost shows where it exceeds the kernel's."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, reps, replays=3):
    """Device time per call of fn() in ms: `reps` calls captured in one CUDA
    graph, replayed between CUDA events, so no host launch cost is in it."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * replays)
    del graph
    return ms


def max_abs_err(got, want):
    """max |got - want| over u64 words (or int32 digits), exactly."""
    import numpy as np

    g = got.cpu().numpy()
    w = want.cpu().numpy()
    if g.shape != w.shape:
        raise AssertionError(f"shape {g.shape} != {w.shape}")
    bad = np.nonzero(g != w)
    if bad[0].size == 0:
        return 0
    if g.dtype == np.int64:
        g, w = g.view(np.uint64), w.view(np.uint64)
    return max(abs(int(a) - int(b)) for a, b in zip(g[bad], w[bad]))


def classic_work(B, G, L, N, P, bits, steps=1):
    """Bytes (each input read once, each output written once) and
    operations of one launch of each classic-schedule wrapper; M, the key
    planes per torus word, follows the torus width.  A Shoup product counts
    6 operations, a modular add 3, a butterfly 9; `steps` is the persistent
    rotation's step count."""
    M = 2 if bits == 64 else 1
    LJ, OM = L * G, G * M
    log_n = N.bit_length() - 1
    acc = B * G * N * 8
    key = 2 * P * LJ * OM * N * 4  # one step's spectra and companions
    k1_ops = B * G * N * (10 + 8 * L)
    butterflies = B * P * (LJ + OM) * (N // 2) * log_n
    mac_ops = (butterflies * 9                # Shoup product + 2 mod adds
               + B * P * OM * N * LJ * 7      # spectrum MAC
               + B * P * LJ * N * 4)          # digits mod p
    garner = B * OM * N * (P * (P - 1) // 2 * 7 + P * 10)
    work = {
        "rotate_decompose": (acc + B * 4 + B * LJ * N * 4, k1_ops),
        "external_product_crt": (B * LJ * N * 4 + key + 2 * acc,
                                 mac_ops + garner),
        "ntt_mac_prime": (B * LJ * N * 4 + key // P + B * OM * N * 4,
                          mac_ops // P),
        "crt_accumulate": (B * OM * P * N * 4 + 2 * acc, garner),
        "pbs_step": (2 * acc + B * 4 + key, k1_ops + mac_ops + garner),
        "blind_rotate_persistent": (
            2 * acc + steps * (B * 4 + key),
            steps * (k1_ops + mac_ops + garner)),
    }
    # K4 does K3's work per step and K7 K5's per rotation
    work["pbs_step_single_cta"] = work["pbs_step"]
    work["blind_rotate_single_cta"] = work["blind_rotate_persistent"]
    return work


def bounds_ms(B, G, L, N, P, bits=64, steps=1):
    """Least time for one launch of each classic-schedule wrapper at these
    shapes: the larger of (bytes read once + written once) / bandwidth and
    operations / peak, and which of the two it is."""
    out = {}
    for name, (nbytes, ops) in classic_work(B, G, L, N, P, bits,
                                            steps).items():
        tb = nbytes / PEAK_BYTES_PER_S * 1e3
        to = ops / PEAK_OPS_PER_S * 1e3
        out[name] = (max(tb, to), "bytes" if tb >= to else "operations")
    return out


def gathered_powers(d, N):
    """How many of the 2N powers of psi the subset degrees d [B, 2^gf]
    gather: t = d_j * e(n) mod 2N over every j >= 1 and position n."""
    import torch

    from tfhe_tpu_torch.ops import ntt

    e = ntt.monomial_tables_for(N, d.device).exponents.to(torch.int64)
    t = (d[:, 1:, None].to(torch.int64) * e) & (2 * N - 1)
    return int(torch.unique(t).numel())


def multibit_bounds_ms(B, G, L, N, P, gf, powers):
    """Least time for one launch of each multi-bit kernel, as bounds_ms,
    with each kernel charged only what the function needs (K9's
    `multibit_step`, and `scan3_group_step`, K8's two launches: a whole
    group step, from the accumulator to the new one; K8's
    `multibit_external_product`: from the accumulator and the combined key
    to the new accumulator): the inputs it reads (of the subset degrees
    only d_1.., of the powers of psi only the `powers` positions this run's
    degrees gather, each with its companion; of the twiddles the N-1 used
    of each of the four rows), the output it writes, and its operations.  A
    Shoup product counts 6 operations, a Barrett product 8, a modular add
    3, a butterfly 9 (as K2), a monomial index 2 (once per ciphertext,
    subset and coefficient: it does not depend on the prime or the
    output); a sum of k terms counts k-1 adds, or, for the MACs' products
    summed lazily into 64 bits, 2 a product (the multiply-adds of its low
    and high words) and 14 a sum (brought into [0, 2p) by two Shoup
    products and a multiply-add)."""
    M, LJ, per = 2, L * G, 1 << gf
    OM = G * M
    W = LJ * OM * N  # one subset key, one prime
    log_n = N.bit_length() - 1
    butterflies = B * P * (LJ + OM) * (N // 2) * log_n
    digits_mod_p = B * P * LJ * N * 4
    garner = B * G * M * N * (P * (P - 1) // 2 * 7 + P * 10)
    spectra = per * P * W * 4  # the group's subset key spectra
    degrees = B * (per - 1) * 4
    gathers = P * powers * 2 * 4 + N * 4  # powers, companions, e(n)
    twiddles = P * (4 * (N - 1) + 3) * 4  # and N^-1, its companion, p
    garner_consts = (P * (P - 1) + 4 * P) * 8  # crt rows, words read
    index = B * N * (per - 1) * 2
    acc = B * G * N * 8
    decompose_ops = B * G * N * (4 + 8 * L)
    work = {
        "multibit_combine": (spectra + degrees + gathers + P * 4
                             + B * P * W * 4,
                             B * P * W * (per - 1) * (6 + 3) + index),
        # the accumulator and the combined key in, the new accumulator out;
        # the digits made inside, no monomial, LJ products an output word
        "multibit_external_product": (
            acc + B * P * W * 4 + twiddles + garner_consts + acc,
            decompose_ops + butterflies * 9
            + B * P * N * OM * (LJ * 2 + 14) + digits_mod_p + garner),
        # the whole group step: the accumulator in and out, the subset key
        # spectra (the MAC needs no companions), the decomposition too; the
        # monomial multiplies the LJ digit spectra or the OM outputs,
        # whichever are fewer, and the per * LJ products of an output sum
        # lazily into 64 bits, reduced once
        "multibit_step": (
            acc + degrees + spectra + gathers + twiddles + garner_consts
            + acc,
            decompose_ops + butterflies * 9
            + B * P * N * (OM * (per * LJ * 2 + 14)
                           + (per - 1) * min(LJ, OM) * 6)
            + index + digits_mod_p + garner),
    }
    # K8's whole group step computes K9's function
    work["scan3_group_step"] = work["multibit_step"]
    out = {}
    for name, (nbytes, ops) in work.items():
        tb = nbytes / PEAK_BYTES_PER_S * 1e3
        to = ops / PEAK_OPS_PER_S * 1e3
        out[name] = (max(tb, to), "bytes" if tb >= to else "operations")
    return out


def multibit_kernels_phase(dev):
    """Each multi-bit kernel against its plain version at GROUP_3's width;
    returns their errors and device / plain times per launch.  Its inputs
    come from a generator of its own: the step's time depends on the subset
    degrees drawn (the bank pattern of its power gathers)."""
    import numpy as np
    import torch

    from tfhe_tpu_torch.ops import fused_multibit as fm
    from tfhe_tpu_torch.params import (
        PARAM_MULTI_BIT_MESSAGE_2_CARRY_2_GROUP_3_KS_PBS as mp)

    t0 = time.time()
    rng = np.random.default_rng(SEED)

    def rand_u64(*shape):
        return torch.from_numpy(
            rng.integers(0, 2**64 - 1, shape, dtype=np.uint64,
                         endpoint=True).view(np.int64)).to(dev)

    N, G, L, bl, gf = (mp.polynomial_size, mp.glwe_size, mp.pbs_level,
                       mp.pbs_base_log, mp.grouping_factor)
    per, groups = 1 << gf, 2
    key = fm.prepare_multi_bit_bsk_cuda(
        rand_u64(groups, per, L, G, G, N), bl, gf)
    acc = rand_u64(B_MAIN, G, N)
    d = torch.from_numpy(rng.integers(0, 2 * N, (groups, B_MAIN, per))
                         .astype(np.int32)).to(dev)
    d[:, :, 0] = 0  # the empty subset's sum switches to 0
    ks = key.kspec[0]

    def stage_errors(acc, d):
        """Each kernel against its plain twin on one group step's inputs."""
        comb = fm.multibit_combine(d, ks)
        comb_p = fm.multibit_combine_plain(d, ks)
        return comb_p, {
            "multibit_combine": max_abs_err(comb, comb_p),
            "multibit_external_product": max_abs_err(
                fm.multibit_external_product(acc, comb_p, bl, L),
                fm.multibit_external_product_plain(acc, comb_p, bl, L)),
            "multibit_step": max_abs_err(
                fm.multibit_step(acc, d, ks, bl, L),
                fm.multibit_step_plain(acc, d, ks, bl, L))}

    comb_p, err = stage_errors(acc, d[0])
    # at B = 256 too, from a generator of its own
    rng_l = np.random.default_rng([SEED, B_LARGE])
    acc_l = torch.from_numpy(rng_l.integers(
        0, 2**64 - 1, (B_LARGE, G, N), dtype=np.uint64, endpoint=True)
        .view(np.int64)).to(dev)
    d_l = torch.from_numpy(rng_l.integers(0, 2 * N, (B_LARGE, per))
                           .astype(np.int32)).to(dev)
    err_l = stage_errors(acc_l, d_l)[1]
    del acc_l, d_l
    rot_p = acc
    for g in range(groups):
        rot_p = fm.multibit_external_product_plain(
            rot_p, fm.multibit_combine_plain(d[g], key.kspec[g]), bl, L)
    rot = {m: fm.multi_bit_blind_rotate_cuda(key, acc, d, mode=m)
           for m in fm.MODES}
    torch.cuda.synchronize()
    err_rot = {m: max_abs_err(r, rot_p) for m, r in rot.items()}
    if any(err.values()) or any(err_rot.values()) or any(err_l.values()):
        raise AssertionError(f"multi-bit kernels disagree with their plain "
                             f"versions: {err}, 2-group rotation {err_rot}, "
                             f"at B = {B_LARGE} {err_l}")

    calls = {
        "multibit_combine": (lambda: fm.multibit_combine(d[0], ks),
                             lambda: fm.multibit_combine_plain(d[0], ks)),
        "multibit_external_product": (
            lambda: fm.multibit_external_product(acc, comb_p, bl, L),
            lambda: fm.multibit_external_product_plain(acc, comb_p, bl, L)),
        "multibit_step": (
            lambda: fm.multibit_step(acc, d[0], ks, bl, L),
            lambda: fm.multibit_step_plain(acc, d[0], ks, bl, L)),
    }
    ms = {k: graph_ms(kern, 100) for k, (kern, _) in calls.items()}
    plain_ms = {k: graph_ms(plain, 3) for k, (_, plain) in calls.items()}
    eager = {k: cuda_ms(kern, 100) for k, (kern, _) in calls.items()}
    powers = gathered_powers(d[0], N)
    bounds = multibit_bounds_ms(B_MAIN, G, L, N, 5, gf, powers)
    say("kernels_multibit", t0,
        shape=dict(B=B_MAIN, G=G, L=L, N=N, P=5, base_log=bl, gf=gf),
        max_abs_err=err, blind_rotation_2_groups_max_abs_err=err_rot,
        max_abs_err_b256=err_l,
        device_ms_per_launch=ms, eager_ms_per_launch=eager,
        plain_device_ms=plain_ms,
        gathered_powers=powers, bound_ms={k: v[0] for k, v in bounds.items()})
    return {k: max(v, err_l[k]) for k, v in err.items()}, ms, plain_ms, bounds


def multibit_main_path(dev):
    """GROUP_3 keys on the card, four LUT evaluations in each schedule;
    returns the launches of each multi-bit kernel and the keys."""
    import numpy as np
    import torch

    from tfhe_tpu_torch import core, shortint
    from tfhe_tpu_torch.ops import fused_multibit as fm
    from tfhe_tpu_torch.ops import fused_pbs
    from tfhe_tpu_torch.params import (
        PARAM_MULTI_BIT_MESSAGE_2_CARRY_2_GROUP_3_KS_PBS as mp)

    t0 = time.time()
    fused_pbs.reset_launch_counts()
    fm.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    cks, sks = shortint.gen_keys(mp, seed=SEED, device=dev)
    torch.cuda.synchronize()
    t_keygen = time.time() - t0
    steps = mp.lwe_dimension // mp.grouping_factor
    msgs = np.arange(B_MAIN) % mp.total_modulus
    batch = cks.encrypt_batch(msgs)
    lhs, rhs = cks.encrypt_batch(msgs % 4), cks.encrypt_batch(msgs // 4)
    funcs = (("identity", lambda x: x), ("mod4", lambda x: x % 4),
             ("div4", lambda x: x // 4))
    blut = sks.generate_lookup_table_bivariate(lambda a, b: (a + b) % 4)
    wants = {name: np.array([f(int(m)) for m in msgs]) % mp.total_modulus
             for name, f in funcs}
    wants["bivariate_add_mod4"] = (msgs % 4 + msgs // 4) % 4

    # scan3, the default, through the ServerKey entry points
    t1 = time.time()
    outs, inputs, correct = {}, {}, {"scan3": {}, "scan1": {}}
    for name, f in funcs:
        lut = sks.generate_lookup_table(f)
        outs[name] = sks.apply_lookup_table_batch(batch, lut).data
        inputs[name] = (batch.data, lut.acc)
    packed = sks.unchecked_add_batch(
        sks.unchecked_scalar_mul_batch(lhs, blut.factor), rhs)
    outs["bivariate_add_mod4"] = sks.unchecked_bivariate_batch(
        lhs, rhs, blut).data
    inputs["bivariate_add_mod4"] = (packed.data, blut.acc.acc)
    torch.cuda.synchronize()
    t_scan3 = time.time() - t1
    launches = {"scan3": {fn.__name__: fn.launches for fn in fm.KERNELS}}
    classic_launches = {fn.__name__: fn.launches for fn in fused_pbs.KERNELS}

    # scan1 through core, on the same inputs
    fm.reset_launch_counts()
    t1 = time.time()
    same = {}
    for name, (data, acc) in inputs.items():
        out1 = core.keyswitch_then_multi_bit_pbs(sks.ksk, sks.bsk, acc, data,
                                                 mode="scan1")
        same[name] = bool(torch.equal(out1, outs[name]))
        for mode, out in (("scan3", outs[name]), ("scan1", out1)):
            got = (cks.decrypt_batch(out) if name == "bivariate_add_mod4"
                   else cks.decrypt_batch_message_and_carry(out))
            correct[mode][name] = int(np.sum(got == wants[name]))
    torch.cuda.synchronize()
    t_scan1 = time.time() - t1
    launches["scan1"] = {fn.__name__: fn.launches for fn in fm.KERNELS}
    say("main_path_multibit", t0, params=mp.name, batch=B_MAIN,
        group_steps=steps, keygen_s=t_keygen, four_luts_s=dict(
            scan3=t_scan3, scan1_and_decrypt=t_scan1), correct=correct,
        scan1_equals_scan3=same, launches=launches,
        classic_launches=classic_launches,
        peak_device_mb=torch.cuda.max_memory_allocated() / 2**20)
    if any(v != B_MAIN for c in correct.values() for v in c.values()):
        raise AssertionError(f"wrong decryptions: {correct} of {B_MAIN}")
    if not all(same.values()):
        raise AssertionError(f"scan1 and scan3 outputs differ: {same}")
    expected = {
        "scan3": dict(multibit_combine=4 * steps,
                      multibit_external_product=4 * steps, multibit_step=0),
        "scan1": dict(multibit_combine=0, multibit_external_product=0,
                      multibit_step=4 * steps)}
    if launches != expected or any(classic_launches.values()):
        raise AssertionError(f"multi-bit main path launched {launches} and "
                             f"classic {classic_launches}, expected "
                             f"{expected} and none")
    total = {k: launches["scan3"][k] + launches["scan1"][k]
             for k in launches["scan3"]}
    return total, cks, sks


def multibit_card_vs_cpu(dev):
    import numpy as np
    import torch

    from tfhe_tpu_torch import shortint
    from tfhe_tpu_torch.params import (
        PARAM_MULTI_BIT_MESSAGE_2_CARRY_2_GROUP_2_TEST as small)

    t0 = time.time()
    outs = {}
    for where in (dev, "cpu"):
        c, s = shortint.gen_keys(small, seed=SEED, device=where)
        b = c.encrypt_batch(np.arange(16))
        o = s.apply_lookup_table_batch(b, s.generate_lookup_table(
            lambda x: (5 * x + 2) % 16))
        outs[where] = o.data.cpu()
        dec = c.decrypt_batch_message_and_carry(o)
        if not np.array_equal(dec, (5 * np.arange(16) + 2) % 16):
            raise AssertionError(f"{where}: multi-bit LUT wrong: {dec}")
    if not torch.equal(outs[dev], outs["cpu"]):
        raise AssertionError("card and CPU multi-bit PBS results differ")
    say("card_vs_cpu_multibit", t0, params=small.name, identical=True)


def multibit_timing(card, dev, cks, sks, rng):
    import numpy as np
    import torch

    from tfhe_tpu_torch.core import (keyswitch, keyswitch_then_multi_bit_pbs,
                                     multi_bit_programmable_bootstrap)
    from tfhe_tpu_torch.ops import fused_multibit as fm

    t0 = time.time()
    p = sks.params
    lut = sks.generate_lookup_table(lambda x: x % 4)
    rates, batch_ms, split_ms = {}, {}, {}
    for mode in fm.MODES:
        for B in (B_MAIN, B_LARGE):
            key = f"{mode}_B{B}"
            data = cks.encrypt_batch(np.arange(B) % 16).data
            run = lambda: keyswitch_then_multi_bit_pbs(  # noqa: E731
                sks.ksk, sks.bsk, lut.acc, data, mode=mode)
            run()  # warm-up
            torch.cuda.synchronize()
            reps = 3
            t1 = time.time()
            for _ in range(reps):
                run()
            torch.cuda.synchronize()
            dt = (time.time() - t1) / reps
            rates[key] = B / dt
            batch_ms[key] = dt * 1e3
            small_ct = keyswitch(sks.ksk, data)
            split_ms[key] = dict(
                keyswitch=cuda_ms(lambda: keyswitch(sks.ksk, data), 3),
                blind_rotate_and_extract=cuda_ms(
                    lambda: multi_bit_programmable_bootstrap(
                        sks.bsk, lut.acc, small_ct, mode), 2, warmup=0))
    G, N, L, bl = p.glwe_size, p.polynomial_size, p.pbs_level, p.pbs_base_log
    acc = torch.zeros((B_LARGE, G, N), dtype=torch.int64, device=dev)
    acc[:, -1] = lut.acc[-1]
    per = 1 << p.grouping_factor
    d = torch.from_numpy(rng.integers(0, 2 * N, (B_LARGE, per))
                         .astype(np.int32)).to(dev)
    ks = sks.bsk.kspec[0]
    comb = fm.multibit_combine(d, ks)
    one_group = dataclasses.replace(sks.bsk, input_dim=p.grouping_factor)
    ms256 = dict(
        multibit_combine=graph_ms(lambda: fm.multibit_combine(d, ks),
                                  50),
        multibit_external_product=graph_ms(
            lambda: fm.multibit_external_product(acc, comb, bl, L), 50),
        multibit_step=graph_ms(lambda: fm.multibit_step(acc, d, ks, bl, L),
                               50),
        # a whole group step in each schedule (scan1's is multibit_step)
        scan3_group_step=graph_ms(lambda: fm.multi_bit_blind_rotate_cuda(
            one_group, acc, d[None], mode="scan3"), 50))
    say("timing_multibit", t0, card=card, params=p.name, pbs_per_s=rates,
        batch_ms=batch_ms, batch_split_ms=split_ms,
        device_ms_per_launch_b256=ms256,
        bound_ms_b256={k: v[0] for k, v in multibit_bounds_ms(
            B_LARGE, G, L, N, 5, p.grouping_factor,
            gathered_powers(d, N)).items()})


# per blind rotation, the launches of each classic-schedule wrapper
def rotation_launches(mode, n, P=5):
    return {"scan2": {"rotate_decompose": n, "external_product_crt": n},
            "scan1": {"pbs_step": n},
            "scan1w": {"pbs_step_single_cta": n},
            "scan3": {"rotate_decompose": n, "ntt_mac_prime": n * P,
                      "crt_accumulate": n},
            "grid": {"blind_rotate_persistent": 1},
            "mega": {"blind_rotate_single_cta": 1}}[mode]


def launched(kernels):
    """The wrappers of `kernels` that launched, with their counts."""
    return {fn.__name__: fn.launches for fn in kernels if fn.launches}


def modes_kernels_phase(dev):
    """Every classic-schedule wrapper against its plain version at the
    widths of PARAM_MESSAGE_2_CARRY_2_KS_PBS and boolean DEFAULT_PARAMETERS
    (B = 64), bit-exact: one step each, the persistent (K5) and the
    single-CTA (K7) rotations at their main path's depth (n = 742, 722
    steps) and at B = 256 too, naming the K7 kernel that ran each batch and
    K5's clusters on the card and waves, and besides a 4-step rotation in
    every mode; with device, eager and plain times and bounds per launch.
    Returns, per width, errors, times and bounds."""
    import numpy as np
    import torch

    from tfhe_tpu_torch.ops import fused_pbs as fp
    from tfhe_tpu_torch.params import (DEFAULT_PARAMETERS,
                                       PARAM_MESSAGE_2_CARRY_2_KS_PBS)

    t0 = time.time()
    rng = np.random.default_rng(SEED)
    P, steps = 5, 4
    out = {}
    for p in (PARAM_MESSAGE_2_CARRY_2_KS_PBS, DEFAULT_PARAMETERS):
        N, G, L, bl, bits = (p.polynomial_size, p.glwe_size, p.pbs_level,
                             p.pbs_base_log, p.torus_bits)
        M, n = (2 if bits == 64 else 1), p.lwe_dimension

        def words(*shape):
            return torch.from_numpy(rng.integers(
                0, 2**bits - 1, shape, dtype=np.uint64, endpoint=True)
                .view(np.int64)).to(dev)

        key = fp.prepare_bsk_cuda(words(steps, L, G, G, N), bl, bits)
        acc = words(B_MAIN, G, N)
        ahat = torch.from_numpy(rng.integers(0, 2 * N, (steps, B_MAIN),
                                             endpoint=True)
                                .astype(np.int32)).to(dev)
        ks, ksh = key.kspec[0], key.kshoup[0]
        # the persistent launch's inputs at the main path's depth, from a
        # generator of their own (the other inputs stay as they were drawn)
        rng_n = np.random.default_rng([SEED, n])
        key_n = fp.prepare_bsk_cuda(torch.from_numpy(rng_n.integers(
            0, 2**bits - 1, (n, L, G, G, N), dtype=np.uint64, endpoint=True)
            .view(np.int64)).to(dev), bl, bits)
        ahat_n = torch.from_numpy(rng_n.integers(0, 2 * N, (n, B_MAIN),
                                                 endpoint=True)
                                  .astype(np.int32)).to(dev)
        dig = fp.rotate_decompose_plain(acc, ahat[0], bl, L, bits)
        res_shape = (B_MAIN, G, M, P, N)
        res_p = torch.empty(res_shape, dtype=torch.int32, device=dev)
        res_k = torch.empty(res_shape, dtype=torch.int32, device=dev)
        for pi in range(P):
            fp.ntt_mac_prime_plain(dig, ks[pi], pi, res_p)
            fp.ntt_mac_prime(dig, ks[pi], ksh[pi], pi, res_k)
        res_t = torch.empty_like(res_p)  # the plain one-prime timing's
        calls = {
            "rotate_decompose": (
                lambda: fp.rotate_decompose(acc, ahat[0], bl, L, bits),
                lambda: fp.rotate_decompose_plain(acc, ahat[0], bl, L, bits)),
            "external_product_crt": (
                lambda: fp.external_product_crt(dig, ks, ksh, acc, bits),
                lambda: fp.external_product_crt_plain(dig, ks, acc, bits)),
            "ntt_mac_prime": (
                lambda: fp.ntt_mac_prime(dig, ks[0], ksh[0], 0, res_k),
                lambda: fp.ntt_mac_prime_plain(dig, ks[0], 0, res_t)),
            "crt_accumulate": (
                lambda: fp.crt_accumulate(res_p, acc, bits),
                lambda: fp.crt_accumulate_plain(res_p, acc, bits)),
            "pbs_step": (
                lambda: fp.pbs_step(acc, ahat[0], ks, ksh, bl, L, bits),
                lambda: fp.pbs_step_plain(acc, ahat[0], ks, bl, L, bits)),
            "pbs_step_single_cta": (
                lambda: fp.pbs_step_single_cta(acc, ahat[0], ks, ksh, bl, L,
                                               bits),
                lambda: fp.pbs_step_plain(acc, ahat[0], ks, bl, L, bits)),
            "blind_rotate_persistent": (
                lambda: fp.blind_rotate_persistent(acc, ahat_n, key_n.kspec,
                                                   key_n.kshoup, bl, L, bits),
                lambda: fp.blind_rotate_persistent_plain(
                    acc, ahat_n, key_n.kspec, bl, L, bits)),
            "blind_rotate_single_cta": (
                lambda: fp.blind_rotate_single_cta(acc, ahat_n, key_n.kspec,
                                                   key_n.kshoup, bl, L, bits),
                lambda: fp.blind_rotate_persistent_plain(
                    acc, ahat_n, key_n.kspec, bl, L, bits)),
        }
        # the whole rotations (K5, K7) share one plain rotation: the same
        # function on the same inputs
        whole = ("blind_rotate_persistent", "blind_rotate_single_cta")
        plain_n = calls[whole[0]][1]()
        err = {k: max_abs_err(kern(), plain_n if k in whole else plain())
               for k, (kern, plain) in calls.items() if k != "ntt_mac_prime"}
        err["ntt_mac_prime"] = max_abs_err(res_k, res_p)
        want = fp.blind_rotate_persistent_plain(acc, ahat, key.kspec, bl, L,
                                                bits)
        err_rot = {m: max_abs_err(fp.blind_rotate_fused(key, acc, ahat, m),
                                  want) for m in fp.MODES}
        # K5 and K7 at the main path's depth at both batch sizes of the
        # main paths: each K7 batch gets the kernel
        # blind_rotate_single_cta_form names (one CTA or a cluster of P per
        # ciphertext); K5 runs a cluster per ciphertext, in as many waves as
        # blind_rotate_persistent_waves says
        rng_l = np.random.default_rng([SEED, n, B_LARGE])
        acc_l = torch.from_numpy(rng_l.integers(
            0, 2**bits - 1, (B_LARGE, G, N), dtype=np.uint64, endpoint=True)
            .view(np.int64)).to(dev)
        ahat_l = torch.from_numpy(rng_l.integers(0, 2 * N, (n, B_LARGE),
                                                 endpoint=True)
                                  .astype(np.int32)).to(dev)
        k7_form = {B: fp.blind_rotate_single_cta_form(B, N, G, L, bits)
                   for B in (B_MAIN, B_LARGE)}
        plain_l = fp.blind_rotate_persistent_plain(acc_l, ahat_l, key_n.kspec,
                                                   bl, L, bits)
        k7_err = {B_MAIN: err["blind_rotate_single_cta"],
                  B_LARGE: max_abs_err(
                      fp.blind_rotate_single_cta(acc_l, ahat_l, key_n.kspec,
                                                 key_n.kshoup, bl, L, bits),
                      plain_l)}
        k7_checked = {f"B{B}": dict(kernel=k7_form[B], max_abs_err=k7_err[B])
                      for B in (B_MAIN, B_LARGE)}
        k5_err = {B_MAIN: err["blind_rotate_persistent"],
                  B_LARGE: max_abs_err(
                      fp.blind_rotate_persistent(acc_l, ahat_l, key_n.kspec,
                                                 key_n.kshoup, bl, L, bits),
                      plain_l)}
        k5_checked = {f"B{B}": dict(
            fp.blind_rotate_persistent_waves(B, N, G, L, bits),
            kernel="blind_rotate_stream_cluster_kernel",
            max_abs_err=k5_err[B]) for B in (B_MAIN, B_LARGE)}
        # K4 and K6's ntt_mac_prime at B = 256 too, on the same batch; K4
        # names its kernel for each batch (a cluster or one CTA per
        # ciphertext)
        dig_l = fp.rotate_decompose_plain(acc_l, ahat_l[0], bl, L, bits)
        res_l = torch.empty((B_LARGE, G, M, P, N), dtype=torch.int32,
                            device=dev)
        res_lp = torch.empty_like(res_l)
        for pi in range(P):
            fp.ntt_mac_prime(dig_l, ks[pi], ksh[pi], pi, res_l)
            fp.ntt_mac_prime_plain(dig_l, ks[pi], pi, res_lp)
        step_l = fp.pbs_step_plain(acc_l, ahat_l[0], ks, bl, L, bits)
        err_l = {k: max_abs_err(getattr(fp, k)(acc_l, ahat_l[0], ks, ksh, bl,
                                               L, bits), step_l)
                 for k in ("pbs_step", "pbs_step_single_cta")}
        err_l["ntt_mac_prime"] = max_abs_err(res_l, res_lp)
        # K3 and K4 run the same kernel, which this names for each batch
        k4_form = {f"B{B}": fp.pbs_step_single_cta_form(B, N, G, L, bits)
                   for B in (B_MAIN, B_LARGE)}
        if (any(err.values()) or any(err_rot.values())
                or any(k7_err.values()) or any(k5_err.values())
                or any(err_l.values())):
            raise AssertionError(
                f"{p.name}: classic kernels disagree with their plain "
                f"versions: {err}, {steps}-step rotation per mode {err_rot}, "
                f"K7 at depth {n} {k7_checked}, K5 {k5_checked}, "
                f"B = {B_LARGE} {err_l}")
        # a persistent or single-CTA launch runs a whole rotation: CUDA
        # events around eager launches, not a graph of 100; their plain
        # version, n steps of plain ops, as one graph replayed once
        per_launch = {k: v for k, v in calls.items() if k not in whole}
        ms = {k: graph_ms(kern, 100) for k, (kern, _) in per_launch.items()}
        eager = {k: cuda_ms(kern, 100) for k, (kern, _) in per_launch.items()}
        plain_ms = {k: graph_ms(plain, 3) for k, (_, plain) in
                    per_launch.items()}
        plain_whole = graph_ms(calls[whole[0]][1], 1, replays=1)
        for k in whole:
            ms[k] = eager[k] = cuda_ms(calls[k][0], 3)
            plain_ms[k] = plain_whole
        rot_ms = {m: cuda_ms(lambda: fp.blind_rotate_fused(  # noqa: B023
            key, acc, ahat, m), 5) for m in fp.MODES}
        bounds = bounds_ms(B_MAIN, G, L, N, P, bits, n)
        say("kernels_modes", t0, params=p.name,
            shape=dict(B=B_MAIN, G=G, L=L, N=N, P=P, base_log=bl, bits=bits,
                       persistent_steps=n, rotation_steps=steps),
            max_abs_err=err, rotation_max_abs_err=err_rot,
            blind_rotate_single_cta_at_depth=k7_checked,
            blind_rotate_persistent_at_depth=k5_checked,
            max_abs_err_b256=err_l, pbs_step_single_cta_kernel=k4_form,
            device_ms_per_launch=ms, eager_ms_per_launch=eager,
            plain_device_ms=plain_ms, rotation_ms_per_mode=rot_ms,
            bound_ms={k: v[0] for k, v in bounds.items()},
            bound_by={k: v[1] for k, v in bounds.items()})
        err_l["blind_rotate_persistent"] = k5_err[B_LARGE]
        err_l["blind_rotate_single_cta"] = k7_err[B_LARGE]
        out[p.name] = ({k: max(v, err_l.get(k, 0)) for k, v in err.items()},
                       ms, plain_ms, bounds)
        del key, key_n, acc, ahat, ahat_n, dig, res_p, res_k, res_t, calls
        del want, plain_n, acc_l, ahat_l, dig_l, res_l, res_lp, step_l
        del plain_l
        torch.cuda.empty_cache()
    return out


BOOLEAN_GATES = ("and", "or", "nand", "nor", "xor", "xnor")


def boolean_main_path(dev):
    """DEFAULT_PARAMETERS keys on the card; every gate and mux on 64 seeded
    bit pairs and triples through boolean.ServerKey in each mode.  Returns
    the launches of each classic wrapper over the six modes, and the
    keys."""
    import copy

    import numpy as np
    import torch

    from tfhe_tpu_torch import boolean
    from tfhe_tpu_torch.ops import fused_pbs as fp
    from tfhe_tpu_torch.params import DEFAULT_PARAMETERS as bp

    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    cks, sks = boolean.gen_keys(bp, seed=SEED, device=dev)
    torch.cuda.synchronize()
    t_keygen = time.time() - t0
    x, y, z = np.random.default_rng(SEED + 1).integers(
        0, 2, (3, B_MAIN)).astype(bool)
    a, b, c = (cks.encrypt_batch(v) for v in (x, y, z))
    clear = {"and": x & y, "or": x | y, "nand": ~(x & y), "nor": ~(x | y),
             "xor": x ^ y, "xnor": ~(x ^ y), "not": ~x,
             "mux": np.where(z, x, y)}
    # six binary gates and one mux (its two bootstraps run as one batch)
    rotations = len(BOOLEAN_GATES) + 1
    outs, correct, launches, wall = {}, {}, {}, {}
    total = {}
    for mode in fp.MODES:
        s = copy.copy(sks)
        s.mode = mode
        fp.reset_launch_counts()
        t1 = time.time()
        o = {g: getattr(s, f"{g}_batch")(a, b) for g in BOOLEAN_GATES}
        o["not"] = s.not_batch(a)
        o["mux"] = s.mux_batch(c, a, b)
        torch.cuda.synchronize()
        wall[mode] = time.time() - t1
        launches[mode] = launched(fp.KERNELS)
        for k, v in launches[mode].items():
            total[k] = total.get(k, 0) + v
        outs[mode] = o
        correct[mode] = {g: int(np.sum(cks.decrypt_batch(v) == clear[g]))
                         for g, v in o.items()}
    same = {m: all(torch.equal(outs[m][g], outs["scan2"][g])
                   for g in outs["scan2"]) for m in fp.MODES}
    expected = {m: {k: v * rotations for k, v in
                    rotation_launches(m, bp.lwe_dimension).items()}
                for m in fp.MODES}
    say("main_path_boolean", t0, params=bp.name, batch=B_MAIN,
        steps=bp.lwe_dimension, keygen_s=t_keygen, gates_s=wall,
        correct=correct, identical_to_scan2=same, launches=launches,
        peak_device_mb=torch.cuda.max_memory_allocated() / 2**20)
    if any(v != B_MAIN for c_ in correct.values() for v in c_.values()):
        raise AssertionError(f"wrong boolean decryptions: {correct} of "
                             f"{B_MAIN}")
    if not all(same.values()):
        raise AssertionError(f"boolean gates differ between modes: {same}")
    if launches != expected:
        raise AssertionError(f"boolean main path launched {launches}, "
                             f"expected {expected}")
    return total, cks, sks


def boolean_card_vs_cpu(dev):
    """BOOLEAN_TEST_PARAMETERS: the card in every mode == the CPU."""
    import copy

    import numpy as np
    import torch

    from tfhe_tpu_torch import boolean
    from tfhe_tpu_torch.ops import fused_pbs as fp
    from tfhe_tpu_torch.params import BOOLEAN_TEST_PARAMETERS as small

    t0 = time.time()
    x, y, z = np.random.default_rng(SEED + 2).integers(
        0, 2, (3, 16)).astype(bool)
    outs = {}
    for where in (dev, "cpu"):
        cks, sks = boolean.gen_keys(small, seed=SEED, device=where)
        a, b, c = (cks.encrypt_batch(v) for v in (x, y, z))
        for mode in (fp.MODES if where == dev else ("scan2",)):
            s = copy.copy(sks)
            s.mode = mode
            o = (s.nand_batch(a, b), s.xor_batch(a, b), s.mux_batch(c, a, b))
            for got, want in zip(o, (~(x & y), x ^ y, np.where(z, x, y))):
                if not np.array_equal(cks.decrypt_batch(got), want):
                    raise AssertionError(f"{where} {mode}: boolean gate "
                                         f"wrong")
            outs[(str(where), mode)] = [t.cpu() for t in o]
    cpu = outs[("cpu", "scan2")]
    same = {k[1]: all(torch.equal(u, v) for u, v in zip(o, cpu))
            for k, o in outs.items() if k[0] != "cpu"}
    say("card_vs_cpu_boolean", t0, params=small.name, identical=same)
    if not all(same.values()):
        raise AssertionError(f"card and CPU boolean gates differ: {same}")


def boolean_timing(card, dev, cks, sks, rng):
    """Gates/s and batch ms per mode at B = 64 and 256 (host clock, launch
    cost included), split into keyswitch, blind rotation and extract."""
    import copy

    import torch

    from tfhe_tpu_torch import core
    from tfhe_tpu_torch.ops import fused_pbs as fp

    t0 = time.time()
    rates, batch_ms, split_ms = {}, {}, {}
    for mode in fp.MODES:
        s = copy.copy(sks)
        s.mode = mode
        for B in (B_MAIN, B_LARGE):
            key = f"{mode}_B{B}"
            a, b = (cks.encrypt_batch(rng.integers(0, 2, B).astype(bool))
                    for _ in range(2))
            s.nand_batch(a, b)  # warm-up
            torch.cuda.synchronize()
            reps = 3
            t1 = time.time()
            for _ in range(reps):
                s.nand_batch(a, b)
            torch.cuda.synchronize()
            dt = (time.time() - t1) / reps
            rates[key] = B / dt
            batch_ms[key] = dt * 1e3
            glwe = core.blind_rotate(s.bsk, s.accumulator, a, mode)
            big = core.sample_extract(glwe, bits=32)
            split_ms[key] = dict(
                blind_rotate=cuda_ms(lambda: core.blind_rotate(  # noqa: B023
                    s.bsk, s.accumulator, a, mode), 2, warmup=0),
                sample_extract=cuda_ms(
                    lambda: core.sample_extract(glwe, bits=32), 20),  # noqa
                keyswitch=cuda_ms(lambda: core.keyswitch(s.ksk, big), 5))
    say("timing_boolean", t0, card=card, params=sks.params.name,
        gates_per_s=rates, batch_ms=batch_ms, batch_split_ms=split_ms)


BIVARIATE_OPS = {
    "mul_lsb": lambda x, y: (x * y) % 4, "mul_msb": lambda x, y: (x * y) // 4,
    "div": lambda x, y: (x // y) % 4 if y else 3,
    "mod_": lambda x, y: (x % y) % 4 if y else x % 4,
    "bitand": lambda x, y: x & y, "bitor": lambda x, y: x | y,
    "bitxor": lambda x, y: x ^ y, "eq": lambda x, y: int(x == y),
    "ne": lambda x, y: int(x != y), "lt": lambda x, y: int(x < y),
    "le": lambda x, y: int(x <= y), "gt": lambda x, y: int(x > y),
    "ge": lambda x, y: int(x >= y)}


def counting_pbs(sks):
    """A copy of sks whose `_pbs_device` adds one to `calls[0]` per PBS
    batch; returns (copy, calls)."""
    import copy

    counted, calls = copy.copy(sks), [0]

    def pbs(data, acc):
        calls[0] += 1
        return sks._pbs_device(data, acc)

    counted._pbs_device = pbs
    return counted, calls


def shortint_ops_main_path(cks, sks):
    """The shortint op families at PARAM_MESSAGE_2_CARRY_2_KS_PBS on the
    main path's keys: every bivariate family's LUT over the 16 clean pairs
    in one many-LUT PBS batch; the neg, sub, scalar-add, scalar-mul,
    trivial and extract batches over the 16 message+carry values; each op
    family once through the one-block API, add and sub at a saturated carry
    (the `_clean` path), checked_add refusing an overflow; then the
    many-LUT batch in scan1w and mega, identical to scan2.  Every
    decryption is checked; launches are exact (n of K1 and of K2 per PBS
    batch in scan2).  Returns the launches."""
    import copy

    import numpy as np
    import torch

    from tfhe_tpu_torch import shortint
    from tfhe_tpu_torch.ops import fused_pbs as fp

    t0 = time.time()
    p = sks.params
    n, msg, total = p.lwe_dimension, p.message_modulus, p.total_modulus
    fp.reset_launch_counts()
    s, calls = counting_pbs(sks)
    names = sorted(BIVARIATE_OPS)
    x, y = np.divmod(np.arange(msg * msg), msg)
    lhs, rhs = np.tile(x, len(names)), np.tile(y, len(names))
    selector = np.repeat(np.arange(len(names)), msg * msg)
    luts = [s.generate_lookup_table_bivariate(BIVARIATE_OPS[k]).acc
            for k in names]
    packed = s.unchecked_add_batch(
        s.unchecked_scalar_mul_batch(cks.encrypt_batch(lhs), msg),
        cks.encrypt_batch(rhs))
    many = s.apply_many_lookup_tables_batch(packed, luts, selector)
    clear = np.array([BIVARIATE_OPS[names[k]](a, b)
                      for k, a, b in zip(selector, lhs, rhs)])
    correct = {"many_luts": int(np.sum(cks.decrypt_batch(many) == clear))}
    wanted = {"many_luts": len(clear)}

    values = np.arange(total)
    vb = cks.encrypt_batch(values)
    xb, yb = cks.encrypt_batch(x), cks.encrypt_batch(y)
    neg, z = s.unchecked_neg_batch(vb)
    sub, _ = s.unchecked_sub_batch(xb, yb)
    batches = {  # name: (batch, clear result, decrypted with its carry)
        "neg": (neg, (z - values) % total, True),
        "sub": (sub, (x - y) % msg, False),
        "scalar_add": (s.unchecked_scalar_add_batch(vb, 5),
                       (values + 5) % total, True),
        "scalar_mul": (s.unchecked_scalar_mul_batch(vb, 3),
                       values * 3 % total, True),
        "trivial": (s.trivial_batch(values * 7, total), values * 7 % total,
                    True),
        "message_extract": (s.message_extract_batch(vb), values % msg, True),
        "carry_extract": (s.carry_extract_batch(vb), values // msg, True)}
    for k, (b, want, with_carry) in batches.items():
        got = (cks.decrypt_batch_message_and_carry(b) if with_carry
               else cks.decrypt_batch(b))
        correct[k], wanted[k] = int(np.sum(got == want)), len(want)

    rng = np.random.default_rng(SEED + 3)
    pairs = rng.integers(0, msg, (len(names) + 2, 2))
    ones = {}
    for (a, b), k in zip(pairs, names + ["add", "sub"]):
        ca, cb = cks.encrypt(int(a)), cks.encrypt(int(b))
        want = (BIVARIATE_OPS[k](a, b) if k in BIVARIATE_OPS
                else (a + b) % msg if k == "add" else (a - b) % msg)
        ones[k] = cks.decrypt(getattr(s, k)(ca, cb)) == want
    a = cks.encrypt(msg - 1)
    ones["neg"] = cks.decrypt(s.neg(a)) == 1
    ones["scalar_left_shift"] = cks.decrypt(s.scalar_left_shift(a, 1)) == (
        (msg - 1) << 1) % msg
    ones["scalar_right_shift"] = cks.decrypt(s.scalar_right_shift(a, 1)) == (
        (msg - 1) >> 1)
    six = s.unchecked_add(cks.encrypt(3), cks.encrypt(3))
    twelve = s.unchecked_add(six, six)
    ones["add_saturated"] = (not s.is_add_possible(twelve, six)
                             and cks.decrypt(s.add(twelve, six)) == 18 % msg)
    ones["sub_saturated"] = cks.decrypt(s.sub(twelve, six)) == 6 % msg
    try:
        s.checked_add(twelve, six)
        ones["checked_add_refuses"] = False
    except shortint.CheckError:
        ones["checked_add_refuses"] = True
    ones = {k: bool(v) for k, v in ones.items()}
    torch.cuda.synchronize()
    launches = launched(fp.KERNELS)
    rotations = calls[0]

    # the many-LUT batch in the single-CTA schedules, on the same input
    same, mode_launches = {}, {}
    for mode in ("scan1w", "mega"):
        sm = copy.copy(sks)
        sm.mode = mode
        fp.reset_launch_counts()
        out = sm.apply_many_lookup_tables_batch(packed, luts, selector)
        torch.cuda.synchronize()
        mode_launches[mode] = launched(fp.KERNELS)
        same[mode] = bool(torch.equal(out.data, many.data))
    say("main_path_shortint_ops", t0, params=p.name,
        many_lut_batch=len(clear), correct=correct, of=wanted,
        one_block_right=ones, pbs_batches=rotations, launches=launches,
        many_luts_identical_to_scan2=same, mode_launches=mode_launches)
    if correct != wanted or not all(ones.values()):
        raise AssertionError(f"shortint ops wrong: {correct} of {wanted}, "
                             f"one-block {ones}")
    want_l = {k: v * rotations for k, v in
              rotation_launches("scan2", n).items()}
    want_m = {m: rotation_launches(m, n) for m in ("scan1w", "mega")}
    if launches != want_l or mode_launches != want_m or not all(
            same.values()):
        raise AssertionError(f"shortint ops launched {launches} (expected "
                             f"{want_l}), modes {mode_launches} (expected "
                             f"{want_m}), identical {same}")
    for v in mode_launches.values():
        for name, c in v.items():
            launches[name] = launches.get(name, 0) + c
    return launches


def pbs_ks_main_path(dev):
    """PARAM_MESSAGE_2_CARRY_2_COMPACT_PK_PBS_KS (ciphertexts under the
    small key, PBS then keyswitch) on the card: keys, three univariate LUTs
    and one bivariate LUT on 64 messages through the ServerKey, decrypted
    right, launches exact; then both PBS orders, classic and multi-bit, on
    the card and on the CPU at small SMALL- and BIG-key copies of the test
    sets, bit-identical.  Returns the launches and the keys."""
    import dataclasses

    import numpy as np
    import torch

    from tfhe_tpu_torch import shortint
    from tfhe_tpu_torch.ops import fused_pbs as fp
    from tfhe_tpu_torch.params import (
        PARAM_MESSAGE_2_CARRY_2_COMPACT_PK_PBS_KS as pk,
        PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST,
        PARAM_MULTI_BIT_MESSAGE_2_CARRY_2_GROUP_2_TEST, EncryptionKeyChoice,
        PBSOrder)

    t0 = time.time()
    fp.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    cks, sks = shortint.gen_keys(pk, seed=SEED, device=dev)
    torch.cuda.synchronize()
    t_keygen = time.time() - t0
    msgs = np.arange(B_MAIN) % pk.total_modulus
    batch = cks.encrypt_batch(msgs)
    correct = {}
    for name, f in (("identity", lambda v: v), ("mod4", lambda v: v % 4),
                    ("div4", lambda v: v // 4)):
        out = sks.apply_lookup_table_batch(batch,
                                           sks.generate_lookup_table(f))
        got = cks.decrypt_batch_message_and_carry(out)
        correct[name] = int(np.sum(got == np.array([f(int(m)) for m in msgs])
                                   % pk.total_modulus))
    blut = sks.generate_lookup_table_bivariate(lambda a, b: (a * b) % 4)
    got = cks.decrypt_batch(sks.unchecked_bivariate_batch(
        cks.encrypt_batch(msgs % 4), cks.encrypt_batch(msgs // 4), blut))
    correct["bivariate_mul_mod4"] = int(np.sum(
        got == (msgs % 4) * (msgs // 4) % 4))
    torch.cuda.synchronize()
    launches = launched(fp.KERNELS)
    say("main_path_pbs_ks", t0, params=pk.name, order=pk.pbs_order.name,
        ciphertext_words=batch.data.shape[1], batch=B_MAIN,
        keygen_s=t_keygen, correct=correct, launches=launches,
        peak_device_mb=torch.cuda.max_memory_allocated() / 2**20)
    if (pk.pbs_order is not PBSOrder.BOOTSTRAP_KEYSWITCH
            or batch.data.shape[1] != pk.lwe_dimension + 1
            or any(v != B_MAIN for v in correct.values())):
        raise AssertionError(f"PBS-then-keyswitch LUTs wrong: {correct} of "
                             f"{B_MAIN}")
    expected = {k: 4 * v for k, v in
                rotation_launches("scan2", pk.lwe_dimension).items()}
    if launches != expected:
        raise AssertionError(f"PBS_KS path launched {launches}, expected "
                             f"{expected}")

    # both orders, classic and multi-bit, card against CPU
    t1 = time.time()
    same = {}
    for small in (PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST,
                  PARAM_MULTI_BIT_MESSAGE_2_CARRY_2_GROUP_2_TEST):
        for choice in (EncryptionKeyChoice.SMALL, EncryptionKeyChoice.BIG):
            q = dataclasses.replace(small, encryption_key_choice=choice)
            outs = {}
            for where in (dev, "cpu"):
                c, s = shortint.gen_keys(q, seed=SEED, device=where)
                b = c.encrypt_batch(np.arange(16))
                o = s.apply_lookup_table_batch(b, s.generate_lookup_table(
                    lambda v: (7 * v + 5) % 16))
                dec = c.decrypt_batch_message_and_carry(o)
                if not np.array_equal(dec, (7 * np.arange(16) + 5) % 16):
                    raise AssertionError(f"{where} {q.name} {choice}: LUT "
                                         f"wrong: {dec}")
                outs[str(where)] = o.data.cpu()
            same[f"{q.name}:{q.pbs_order.name}"] = bool(
                torch.equal(outs[str(dev)], outs["cpu"]))
    say("card_vs_cpu_both_orders", t1, identical=same)
    if not all(same.values()):
        raise AssertionError(f"card and CPU differ: {same}")
    return launches, cks, sks


# the CRT-NTT key layout on K10 (the Shoup MAC), at the three torus widths:
# (name, LJ = L*G digit rows, GM = G*M output planes, N)
NTT_WIDTHS = (("shortint", 2, 4, 2048), ("boolean", 9, 3, 512),
              ("u128", 2, 8, 2048))
# the u128 PBS at the PBS widths and noise of PARAM_MESSAGE_2_CARRY_2_KS_PBS
U128_MSUP = 4
U128_LUTS = (("identity", lambda x: x),
             ("3x_plus_1", lambda x: (3 * x + 1) % 4))


def shoup_mac_bound_ms(B, LJ, GM, N, P=1):
    """Least time for K10's work over P primes (one step of the main paths
    with P = 5, whatever launches it takes): its bytes (digit spectra, key
    spectra and companions read once, the sums written once) over the
    bandwidth, against its operations (per term a Shoup product 6, four
    corrections 2 each and the add; per output the centring 5) over the
    peak."""
    nbytes = P * (B * LJ * N + 2 * LJ * GM * N + B * GM * N) * 4
    ops = P * B * GM * N * (LJ * 15 + 5)
    tb = nbytes / PEAK_BYTES_PER_S * 1e3
    to = ops / PEAK_OPS_PER_S * 1e3
    return max(tb, to), "bytes" if tb >= to else "operations"


def ntt_kernels_phase(dev):
    """K10 against its plain versions at the three widths, B = 64,
    bit-exact: `shoup_mac` for every prime, and `shoup_mac_primes` over all
    five (the main paths' one launch a step); device (a CUDA graph of 100
    launches), eager and plain times of a step (all primes: one
    `shoup_mac_primes` launch, and five of `shoup_mac` beside it), and its
    bounds."""
    import numpy as np
    import torch

    from tfhe_tpu_torch.ops import ntt
    from tfhe_tpu_torch.ops import shoup_mac as sm

    t0 = time.time()
    rng = np.random.default_rng([SEED, 10])
    P = len(ntt.PRIMES)
    err, ms, eager, plain_ms, per_prime_ms, bounds = {}, {}, {}, {}, {}, {}
    for name, LJ, GM, N in NTT_WIDTHS:
        worst = 0
        a, ks, ksh = [], [], []
        for p in ntt.PRIMES:
            h = p // 2
            a.append(torch.from_numpy(rng.integers(-h, h + 1, (B_MAIN, LJ, N))
                                      .astype(np.int32)).to(dev))
            ks.append(torch.from_numpy(rng.integers(-h, h + 1, (LJ, GM, N))
                                       .astype(np.int32)).to(dev))
            ksh.append(ntt.shoup16(ks[-1], p))
            worst = max(worst, max_abs_err(
                sm.shoup_mac(a[-1], ks[-1], ksh[-1], p),
                sm.shoup_mac_plain(a[-1], ks[-1], ksh[-1], p)))
        a, ks, ksh = (torch.stack(x) for x in (a, ks, ksh))

        def kern(a=a, ks=ks, ksh=ksh):
            return sm.shoup_mac_primes(a, ks, ksh, ntt.PRIMES)

        def plain(a=a, ks=ks, ksh=ksh):
            return sm.shoup_mac_primes_plain(a, ks, ksh, ntt.PRIMES)

        def per_prime(a=a, ks=ks, ksh=ksh):
            for i, p in enumerate(ntt.PRIMES):
                sm.shoup_mac(a[i], ks[i], ksh[i], p)

        err[name] = max(worst, max_abs_err(kern(), plain()))
        ms[name] = graph_ms(kern, 100)
        eager[name] = cuda_ms(kern, 100)
        plain_ms[name] = graph_ms(plain, 3)
        per_prime_ms[name] = graph_ms(per_prime, 100)
        bounds[name] = shoup_mac_bound_ms(B_MAIN, LJ, GM, N, P)
    say("kernels_ntt", t0, batch=B_MAIN,
        shapes={n: dict(LJ=lj, GM=gm, N=nn, P=P)
                for n, lj, gm, nn in NTT_WIDTHS},
        max_abs_err=err, device_ms_per_step=ms, eager_ms_per_step=eager,
        plain_device_ms_per_step=plain_ms,
        device_ms_per_step_one_prime_a_launch=per_prime_ms,
        bound_ms_per_step={k: v[0] for k, v in bounds.items()},
        bound_by={k: v[1] for k, v in bounds.items()})
    if any(err.values()):
        raise AssertionError(f"shoup_mac disagrees with its plain version: "
                             f"{err}")
    return err, ms, plain_ms, bounds


def all_launches():
    """Every wrapper's launch count, by name."""
    from tfhe_tpu_torch.ops import fused_multibit, fused_pbs, shoup_mac

    return launched(fused_pbs.KERNELS + fused_multibit.KERNELS
                    + shoup_mac.KERNELS)


def reset_all_launches():
    from tfhe_tpu_torch.ops import fused_multibit, fused_pbs, shoup_mac

    for mod in (fused_pbs, fused_multibit, shoup_mac):
        mod.reset_launch_counts()


def ntt_main_path(dev):
    """mode="ntt" at full width: PARAM_MESSAGE_2_CARRY_2_KS_PBS keys on the
    card, two LUTs on 64 messages, decrypted right and equal word for word
    to a scan2 key rebuilt from the same raw keys; boolean DEFAULT_PARAMETERS
    gates and mux the same way.  K10 launches are exact: n per PBS batch
    (one `shoup_mac_primes` launch a step), nothing else launches.  Returns
    K10's launches."""
    import numpy as np
    import torch

    from tfhe_tpu_torch import boolean, shortint
    from tfhe_tpu_torch.params import DEFAULT_PARAMETERS as bp
    from tfhe_tpu_torch.params import PARAM_MESSAGE_2_CARRY_2_KS_PBS as p

    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    cks, sks = shortint.gen_keys(p, seed=SEED, device=dev, mode="ntt")
    torch.cuda.synchronize()
    t_keygen = time.time() - t0
    msgs = np.arange(B_MAIN) % p.total_modulus
    batch = cks.encrypt_batch(msgs)
    funcs = (("identity", lambda x: x), ("div4", lambda x: x // 4))
    reset_all_launches()
    t1 = time.time()
    outs = {name: sks.apply_lookup_table_batch(
        batch, sks.generate_lookup_table(f)).data for name, f in funcs}
    torch.cuda.synchronize()
    t_luts = time.time() - t1
    launches = {"shortint": all_launches()}
    correct = {name: int(np.sum(cks.decrypt_batch_message_and_carry(outs[name])
                                == np.array([f(int(m)) for m in msgs])))
               for name, f in funcs}
    scan2 = shortint.ServerKey.from_raw(p, sks.raw_bsk, sks.raw_ksk,
                                        device=dev, mode="scan2")
    same = {name: bool(torch.equal(scan2.apply_lookup_table_batch(
        batch, scan2.generate_lookup_table(f)).data, outs[name]))
        for name, f in funcs}
    peak_shortint = torch.cuda.max_memory_allocated() / 2**20
    del cks, sks, scan2, batch, outs
    torch.cuda.empty_cache()

    # boolean gates and mux
    t2 = time.time()
    bcks, bsks = boolean.gen_keys(bp, seed=SEED, device=dev, mode="ntt")
    torch.cuda.synchronize()
    t_keygen_bool = time.time() - t2
    x, y, z = np.random.default_rng(SEED + 1).integers(
        0, 2, (3, B_MAIN)).astype(bool)
    a, b, c = (bcks.encrypt_batch(v) for v in (x, y, z))
    clear = {"and": x & y, "or": x | y, "nand": ~(x & y), "nor": ~(x | y),
             "xor": x ^ y, "xnor": ~(x ^ y), "mux": np.where(z, x, y)}
    reset_all_launches()
    t1 = time.time()
    gates = {g: getattr(bsks, f"{g}_batch")(a, b) for g in BOOLEAN_GATES}
    gates["mux"] = bsks.mux_batch(c, a, b)
    torch.cuda.synchronize()
    t_gates = time.time() - t1
    launches["boolean"] = all_launches()
    for g, o in gates.items():
        correct[f"boolean_{g}"] = int(np.sum(bcks.decrypt_batch(o)
                                             == clear[g]))
    bscan2 = boolean.ServerKey.from_raw(bp, bsks.raw_bsk, bsks.raw_ksk,
                                        device=dev, mode="scan2")
    for g in BOOLEAN_GATES:
        same[f"boolean_{g}"] = bool(torch.equal(
            getattr(bscan2, f"{g}_batch")(a, b), gates[g]))
    same["boolean_mux"] = bool(torch.equal(bscan2.mux_batch(c, a, b),
                                           gates["mux"]))
    expected = {"shortint": {"shoup_mac_primes": p.lwe_dimension
                             * len(funcs)},
                "boolean": {"shoup_mac_primes": bp.lwe_dimension
                            * (len(BOOLEAN_GATES) + 1)}}
    say("main_path_ntt", t0, params=[p.name, bp.name], batch=B_MAIN,
        keygen_s=dict(shortint=t_keygen, boolean=t_keygen_bool),
        two_luts_s=t_luts, seven_gate_batches_s=t_gates, correct=correct,
        identical_to_scan2=same, launches=launches,
        peak_device_mb=dict(
            shortint=peak_shortint,
            boolean=torch.cuda.max_memory_allocated() / 2**20))
    if any(v != B_MAIN for v in correct.values()) or not all(same.values()):
        raise AssertionError(f"mode='ntt': correct {correct} of {B_MAIN}, "
                             f"identical to scan2 {same}")
    if launches != expected:
        raise AssertionError(f"mode='ntt' launched {launches}, expected "
                             f"{expected}")
    return sum(v["shoup_mac_primes"] for v in launches.values())


def u128_keys(dev, n, k, N, base_log, levels, lwe_std, glwe_std, seed):
    """u128 secret keys, bootstrap key and its NTT layout on `dev`."""
    from tfhe_tpu_torch import core
    from tfhe_tpu_torch.prng import Seeder
    from tfhe_tpu_torch.prng.generators import (EncryptionRandomGenerator,
                                                SecretRandomGenerator)

    sec = SecretRandomGenerator(seed)
    enc = EncryptionRandomGenerator(seed + 1, Seeder(seed + 1))
    lwe = core.generate_binary_lwe_secret_key_u128(n, sec, device=dev)
    glwe = core.generate_binary_lwe_secret_key_u128(k * N, sec,
                                                    device=dev).reshape(k, N)
    raw = core.generate_bootstrap_key_u128(lwe, glwe, base_log, levels,
                                           glwe_std, enc)
    return lwe, glwe, raw, core.prepare_bsk_ntt(raw, base_log, bits=128,
                                                device=dev), enc


def u128_lut_check(bsk, lwe, glwe, enc, lwe_std, B):
    """The u128 PBS of the two LUTs on B encryptions of x in [0, 4):
    returns outputs, the ciphertexts, and the count decrypted right."""
    import numpy as np

    from tfhe_tpu_torch import core
    from tfhe_tpu_torch.ops import u128

    k, N = glwe.shape
    delta = (1 << 128) // (2 * U128_MSUP)
    msgs = np.arange(B) % U128_MSUP
    cts = core.encrypt_lwe_u128(lwe, [int(m) * delta for m in msgs], lwe_std,
                                enc)
    outs, correct = {}, {}
    for name, f in U128_LUTS:
        acc = core.fill_accumulator_u128(f, N, k + 1, U128_MSUP, delta,
                                         device=glwe.device)
        outs[name] = core.programmable_bootstrap(bsk, acc, cts)
        phases = u128.np_unpack(u128.to_numpy(core.decrypt_lwe_u128(
            glwe.reshape(-1), outs[name])))
        got = [((ph + delta // 2) // delta) % (2 * U128_MSUP)
               for ph in phases]
        correct[name] = int(sum(g == f(int(m)) % U128_MSUP
                                for g, m in zip(got, msgs)))
    return outs, cts, correct


def u128_main_path(dev):
    """The u128 PBS at the PBS widths and noise of
    PARAM_MESSAGE_2_CARRY_2_KS_PBS (n = 742, N = 2048, k = 1, base_log 23,
    one level): keygen on the card, the CRT-NTT layout, the identity and
    (3x+1) mod 4 LUTs on 64 encryptions, all decrypted right; n K10
    launches per rotation.  Returns K10's launches and the keys."""
    import torch

    from tfhe_tpu_torch.params import PARAM_MESSAGE_2_CARRY_2_KS_PBS as p

    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    lwe, glwe, raw, bsk, enc = u128_keys(
        dev, p.lwe_dimension, p.glwe_dimension, p.polynomial_size,
        p.pbs_base_log, p.pbs_level, p.lwe_modular_std_dev,
        p.glwe_modular_std_dev, SEED)
    torch.cuda.synchronize()
    t_keygen = time.time() - t0
    reset_all_launches()
    t1 = time.time()
    _, _, correct = u128_lut_check(bsk, lwe, glwe, enc,
                                   p.lwe_modular_std_dev, B_MAIN)
    torch.cuda.synchronize()
    t_luts = time.time() - t1
    launches = all_launches()
    expected = {"shoup_mac_primes": p.lwe_dimension * len(U128_LUTS)}
    say("main_path_u128", t0, widths_of=p.name, n=p.lwe_dimension,
        N=p.polynomial_size, k=p.glwe_dimension, base_log=p.pbs_base_log,
        levels=p.pbs_level, batch=B_MAIN, keygen_s=t_keygen,
        two_luts_and_decrypt_s=t_luts, correct=correct, launches=launches,
        peak_device_mb=torch.cuda.max_memory_allocated() / 2**20)
    if any(v != B_MAIN for v in correct.values()):
        raise AssertionError(f"u128 LUTs wrong: {correct} of {B_MAIN}")
    if launches != expected:
        raise AssertionError(f"u128 path launched {launches}, expected "
                             f"{expected}")
    del raw
    return launches["shoup_mac_primes"], (lwe, glwe, bsk, enc)


def ntt_card_vs_cpu(dev):
    """mode="ntt" on the card == the CPU's plain path, word for word: the
    shortint and boolean TEST sets, and the u128 PBS at tests/test_u128.py's
    toy size (n = 4, k = 1, N = 64, base_log 18, 2 levels)."""
    import numpy as np
    import torch

    from tfhe_tpu_torch import boolean, shortint
    from tfhe_tpu_torch.params import (BOOLEAN_TEST_PARAMETERS,
                                       PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST)

    t0 = time.time()
    outs = {}
    x, y = np.random.default_rng(SEED + 4).integers(0, 2, (2, 16)).astype(
        bool)
    for where in (dev, "cpu"):
        c, s = shortint.gen_keys(PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST,
                                 seed=SEED, device=where, mode="ntt")
        o = s.apply_lookup_table_batch(c.encrypt_batch(np.arange(16)),
                                       s.generate_lookup_table(
                                           lambda v: (3 * v + 1) % 16))
        if not np.array_equal(c.decrypt_batch_message_and_carry(o),
                              (3 * np.arange(16) + 1) % 16):
            raise AssertionError(f"{where}: ntt shortint LUT wrong")
        bc, bs = boolean.gen_keys(BOOLEAN_TEST_PARAMETERS, seed=SEED,
                                  device=where, mode="ntt")
        g = bs.xor_batch(bc.encrypt_batch(x), bc.encrypt_batch(y))
        if not np.array_equal(bc.decrypt_batch(g), x ^ y):
            raise AssertionError(f"{where}: ntt boolean gate wrong")
        lwe, glwe, raw, bsk, enc = u128_keys(where, 4, 1, 64, 18, 2,
                                             2.0 ** -60, 2.0 ** -60, SEED)
        u_outs, _, correct = u128_lut_check(bsk, lwe, glwe, enc, 2.0 ** -60,
                                            16)
        if any(v != 16 for v in correct.values()):
            raise AssertionError(f"{where}: toy u128 LUTs wrong: {correct}")
        outs[str(where)] = [o.data.cpu(), g.cpu(), raw.cpu()] + [
            u.cpu() for u in u_outs.values()]
    names = ("shortint", "boolean", "u128_bsk") + tuple(
        f"u128_{n}" for n, _ in U128_LUTS)
    same = {n: bool(torch.equal(u, v)) for n, u, v in
            zip(names, outs[str(dev)], outs["cpu"])}
    say("card_vs_cpu_ntt", t0, identical=same)
    if not all(same.values()):
        raise AssertionError(f"card and CPU differ in mode='ntt': {same}")


def ntt_timing(card, dev, u128_state, rng):
    """PBS/s and batch ms (host clock after a warm-up, launch cost
    included) at B = 64 and 256: shortint mode="ntt", the u128 PBS, boolean
    gates; and a CUDA-event split of one shortint and one u128 step into
    decomposition, forward NTT, K10 (one launch), inverse NTT and CRT."""
    import numpy as np
    import torch

    from tfhe_tpu_torch import boolean, core, shortint
    from tfhe_tpu_torch.ops import polymul_ntt as pn
    from tfhe_tpu_torch.ops import u128
    from tfhe_tpu_torch.params import DEFAULT_PARAMETERS as bp
    from tfhe_tpu_torch.params import PARAM_MESSAGE_2_CARRY_2_KS_PBS as p

    t0 = time.time()
    rates, batch_ms, split_ms = {}, {}, {}

    def clock(key, B, run):
        run()  # warm-up
        torch.cuda.synchronize()
        reps = 2 if B == B_MAIN else 1
        t1 = time.time()
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        dt = (time.time() - t1) / reps
        rates[key], batch_ms[key] = B / dt, dt * 1e3

    def split(key, bsk, acc, bits):
        """One step's stages on the accumulator acc, CUDA events each."""
        G = bsk.glwe_size
        diff = acc  # any torus words: the stages' times do not depend on them
        digits = pn.decompose_digits(diff, bsk.base_log, bsk.levels, bits)
        dspec = pn.digit_spectra(digits)
        prods = pn.spectral_mac(dspec, bsk.spectra[0], bsk.shoup[0])
        res = pn.inverse_residues(prods, G, bits // 32)
        split_ms[key] = dict(
            decompose=cuda_ms(lambda: pn.decompose_digits(
                diff, bsk.base_log, bsk.levels, bits), 20),
            forward_ntt=cuda_ms(lambda: pn.digit_spectra(digits), 20),
            shoup_mac_all_primes=cuda_ms(lambda: pn.spectral_mac(
                dspec, bsk.spectra[0], bsk.shoup[0]), 20),
            inverse_ntt=cuda_ms(lambda: pn.inverse_residues(
                prods, G, bits // 32), 20),
            crt_and_planes=cuda_ms(lambda: pn.residues_to_words(res, bits),
                                   20),
            whole_step=cuda_ms(lambda: pn.external_product_ntt(
                diff, bsk.spectra[0], bsk.shoup[0], bsk.base_log,
                bsk.levels, bits), 20))

    cks, sks = shortint.gen_keys(p, seed=SEED + 5, device=dev, mode="ntt")
    lut = sks.generate_lookup_table(lambda x: x % 4)
    for B in (B_MAIN, B_LARGE):
        data = cks.encrypt_batch(np.arange(B) % 16).data
        clock(f"shortint_ntt_B{B}", B, lambda: core.keyswitch_then_pbs(
            sks.ksk, sks.bsk, lut.acc, data, "ntt"))  # noqa: B023
        acc = torch.from_numpy(rng.integers(
            0, 2**63, (B, p.glwe_size, p.polynomial_size))).to(dev)
        split(f"shortint_B{B}", sks.bsk, acc, 64)
    del cks, sks, lut, data, acc
    torch.cuda.empty_cache()

    lwe, glwe, bsk, enc = u128_state
    k, N = glwe.shape
    delta = (1 << 128) // (2 * U128_MSUP)
    acc128 = core.fill_accumulator_u128(lambda x: x, N, k + 1, U128_MSUP,
                                        delta, device=dev)
    for B in (B_MAIN, B_LARGE):
        cts = core.encrypt_lwe_u128(
            lwe, [int(m) * delta for m in np.arange(B) % U128_MSUP],
            p.lwe_modular_std_dev, enc)
        clock(f"u128_B{B}", B, lambda: core.programmable_bootstrap(
            bsk, acc128, cts))  # noqa: B023
        acc = u128.to_tensor(rng.integers(0, 2**64 - 1, (B, k + 1, N, 2),
                                          dtype=np.uint64, endpoint=True),
                             dev)
        split(f"u128_B{B}", bsk, acc, 128)
    del cts, acc

    bcks, bsks = boolean.gen_keys(bp, seed=SEED + 6, device=dev, mode="ntt")
    for B in (B_MAIN, B_LARGE):
        a, b = (bcks.encrypt_batch(rng.integers(0, 2, B).astype(bool))
                for _ in range(2))
        clock(f"boolean_ntt_B{B}", B, lambda: bsks.nand_batch(a, b))  # noqa
    say("timing_ntt", t0, card=card, pbs_or_gates_per_s=rates,
        batch_ms=batch_ms, step_split_ms=split_ms)


def main():
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    t_start = time.time()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card",
              file=sys.stderr, flush=True)
        return 1
    from tfhe_tpu_torch import prng, shortint
    from tfhe_tpu_torch.core import (keyswitch, keyswitch_then_pbs,
                                     pbs_then_keyswitch,
                                     programmable_bootstrap)
    from tfhe_tpu_torch.ops import fused_multibit, fused_pbs, shoup_mac
    from tfhe_tpu_torch.params import (PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST,
                                       PARAM_MESSAGE_2_CARRY_2_KS_PBS)

    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    say("card", t_start, nvidia_smi=card, torch_name=kind,
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)

    # -- 2. build ---------------------------------------------------------
    t0 = time.time()

    def timed(build):
        t = time.time()
        build()
        return round(time.time() - t, 3)

    builds = (fused_pbs.cuda_library, fused_pbs.single_cta_library,
              fused_multibit.cuda_library, shoup_mac.cuda_library,
              prng.native_library)
    with ThreadPoolExecutor(len(builds)) as pool:
        t_nvcc, t_nvcc_single, t_nvcc_mb, t_nvcc_shoup, t_gxx = pool.map(
            timed, builds)
    aes = prng.Aes128(0x0123456789ABCDEF, backend="native")
    ref = prng.Aes128(0x0123456789ABCDEF, backend="numpy")
    if not np.array_equal(aes.ctr_blocks(7, 64), ref.ctr_blocks(7, 64)):
        raise AssertionError("native AES disagrees with the numpy AES")
    say("build", t0, nvcc_s=t_nvcc, nvcc_single_cta_s=t_nvcc_single, nvcc_multibit_s=t_nvcc_mb,
        nvcc_shoup_mac_s=t_nvcc_shoup, gxx_s=t_gxx, aes_backend=aes.backend)

    # -- 3. kernels against their plain versions ----------------------------
    # the multi-bit kernels first, from a generator of their own.  Timed
    # after the classic phases, on the shared generator's later draws, the
    # step kernel once read 12% slower than the parent's smoke; on fixed
    # inputs (kernel_times.py) that was not reproduced, so the cause may be
    # the draw of subset degrees (PERF.md)
    mb_err, mb_ms, mb_plain_ms, mb_bounds = multibit_kernels_phase(dev)
    p = PARAM_MESSAGE_2_CARRY_2_KS_PBS
    N, G, L, bl = p.polynomial_size, p.glwe_size, p.pbs_level, p.pbs_base_log
    P = 5
    rng = np.random.default_rng(SEED)  # the timing phases' inputs
    modes_k = modes_kernels_phase(dev)
    ntt_k = ntt_kernels_phase(dev)

    # -- 4. main path -------------------------------------------------------
    t0 = time.time()
    fused_pbs.reset_launch_counts()
    cks, sks = shortint.gen_keys(p, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    t_keygen = time.time() - t0
    msgs = np.arange(B_MAIN) % p.total_modulus
    batch = cks.encrypt_batch(msgs)
    results = {}
    for name, f in (("identity", lambda x: x), ("mod4", lambda x: x % 4),
                    ("div4", lambda x: x // 4)):
        out = sks.apply_lookup_table_batch(batch,
                                           sks.generate_lookup_table(f))
        got = cks.decrypt_batch_message_and_carry(out)
        want = np.array([f(int(m)) for m in msgs]) % p.total_modulus
        results[name] = int(np.sum(got == want))
    lhs = cks.encrypt_batch(msgs % 4)
    rhs = cks.encrypt_batch(msgs // 4)
    blut = sks.generate_lookup_table_bivariate(lambda a, b: (a + b) % 4)
    got = cks.decrypt_batch(sks.unchecked_bivariate_batch(lhs, rhs, blut))
    results["bivariate_add_mod4"] = int(np.sum(got == (msgs % 4 + msgs // 4)
                                               % 4))
    torch.cuda.synchronize()
    launches = launched(fused_pbs.KERNELS)
    say("main_path", t0, params=p.name, batch=B_MAIN, keygen_s=t_keygen,
        correct=results, launches=launches)
    if any(v != B_MAIN for v in results.values()):
        raise AssertionError(f"wrong decryptions: {results} of {B_MAIN}")
    expected = {k: 4 * v for k, v in
                rotation_launches("scan2", p.lwe_dimension).items()}
    if launches != expected:
        raise AssertionError(f"main path launched {launches}, expected "
                             f"{expected}")

    # the classic schedules at full width, on the main path's 64 messages
    t1 = time.time()
    lut_id = sks.generate_lookup_table(lambda x: x)
    outs_m, launches_m = {}, {}
    for mode in fused_pbs.MODES:
        fused_pbs.reset_launch_counts()
        outs_m[mode] = keyswitch_then_pbs(sks.ksk, sks.bsk, lut_id.acc,
                                          batch.data, mode)
        torch.cuda.synchronize()
        launches_m[mode] = launched(fused_pbs.KERNELS)
        for k, v in launches_m[mode].items():
            launches[k] = launches.get(k, 0) + v
    t_main = time.time() - t0
    same = {m: bool(torch.equal(o, outs_m["scan2"])) for m, o in
            outs_m.items()}
    correct = {m: int(np.sum(cks.decrypt_batch_message_and_carry(o) == msgs))
               for m, o in outs_m.items()}
    say("main_path_modes", t1, params=p.name, batch=B_MAIN,
        identical_to_scan2=same, correct=correct, launches=launches_m)
    want_m = {m: rotation_launches(m, p.lwe_dimension)
              for m in fused_pbs.MODES}
    if (not all(same.values()) or any(v != B_MAIN for v in correct.values())
            or launches_m != want_m):
        raise AssertionError(f"classic modes: identical {same}, correct "
                             f"{correct} of {B_MAIN}, launches {launches_m} "
                             f"(expected {want_m})")

    # the same pipeline at a small size, on the card and on the CPU
    t1 = time.time()
    small = PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST
    outs = {}
    for where in ("cuda", "cpu"):
        c, s = shortint.gen_keys(small, seed=SEED, device=where)
        b = c.encrypt_batch(np.arange(16))
        o = s.apply_lookup_table_batch(b, s.generate_lookup_table(
            lambda x: (3 * x + 1) % 16))
        outs[where] = o.data.cpu()
        dec = c.decrypt_batch_message_and_carry(o)
        if not np.array_equal(dec, (3 * np.arange(16) + 1) % 16):
            raise AssertionError(f"{where}: small-parameter LUT wrong: {dec}")
    if not torch.equal(outs["cuda"], outs["cpu"]):
        raise AssertionError("card and CPU PBS results differ")
    say("card_vs_cpu", t1, params=small.name, identical=True)

    # -- the shortint op families, and the PBS-then-keyswitch order ---------
    t1 = time.time()
    for k, v in shortint_ops_main_path(cks, sks).items():
        launches[k] = launches.get(k, 0) + v
    t_ops = time.time() - t1
    t1 = time.time()
    pk_launches, pk_cks, pk_sks = pbs_ks_main_path(dev)
    t_pbs_ks = time.time() - t1
    for k, v in pk_launches.items():
        launches[k] = launches.get(k, 0) + v

    # -- 5. timing ----------------------------------------------------------
    t0 = time.time()
    lut = sks.generate_lookup_table(lambda x: x % 4)
    rates, batch_ms, split_ms = {}, {}, {}
    for mode, B in ((m, B) for m in fused_pbs.MODES for B in (B_MAIN,
                                                             B_LARGE)):
        key = str(B) if mode == "scan2" else f"{mode}_B{B}"
        data = cks.encrypt_batch(np.arange(B) % 16).data
        keyswitch_then_pbs(sks.ksk, sks.bsk, lut.acc, data, mode)  # warm-up
        torch.cuda.synchronize()
        reps = 3
        t1 = time.time()
        for _ in range(reps):
            keyswitch_then_pbs(sks.ksk, sks.bsk, lut.acc, data, mode)
        torch.cuda.synchronize()
        dt = (time.time() - t1) / reps
        rates[key] = B / dt
        batch_ms[key] = dt * 1e3
        small_ct = keyswitch(sks.ksk, data)
        split_ms[key] = dict(
            keyswitch=cuda_ms(lambda: keyswitch(sks.ksk, data), 3),
            blind_rotate_and_extract=cuda_ms(
                lambda: programmable_bootstrap(  # noqa: B023
                    sks.bsk, lut.acc, small_ct, mode), 2, warmup=0))
    acc = torch.zeros((B_LARGE, G, N), dtype=torch.int64, device=dev)
    acc[:, -1] = lut.acc[-1]
    ahat = torch.from_numpy(rng.integers(0, 2 * N, (B_LARGE,))
                            .astype(np.int32)).to(dev)
    dig = fused_pbs.rotate_decompose(acc, ahat, bl, L)
    ms256_k1 = graph_ms(lambda: fused_pbs.rotate_decompose(acc, ahat, bl, L),
                        100)
    ms256_k2 = graph_ms(lambda: fused_pbs.external_product_crt(
        dig, sks.bsk.kspec[0], sks.bsk.kshoup[0], acc), 100)
    # the PBS_KS set (PBS then keyswitch, n = 1024) in scan2
    for B in (B_MAIN, B_LARGE):
        key = f"{pk_sks.params.name}_B{B}"
        data = pk_cks.encrypt_batch(np.arange(B) % 16).data
        pk_lut = pk_sks.generate_lookup_table(lambda x: x % 4).acc
        pbs_then_keyswitch(pk_sks.ksk, pk_sks.bsk, pk_lut, data)  # warm-up
        torch.cuda.synchronize()
        t1 = time.time()
        for _ in range(3):
            pbs_then_keyswitch(pk_sks.ksk, pk_sks.bsk, pk_lut, data)
        torch.cuda.synchronize()
        dt = (time.time() - t1) / 3
        rates[key] = B / dt
        batch_ms[key] = dt * 1e3
    say("timing", t0, card=card, pbs_per_s=rates, batch_ms=batch_ms,
        batch_split_ms=split_ms, device_ms_per_launch_b256=dict(
            rotate_decompose=ms256_k1, external_product_crt=ms256_k2),
        bound_ms_b256={k: v[0] for k, v in
                       bounds_ms(B_LARGE, G, L, N, P).items()
                       if k in ("rotate_decompose", "external_product_crt")})

    del sks, cks, lut, acc, dig, data, small_ct, pk_sks, pk_cks, pk_lut
    torch.cuda.empty_cache()

    # -- 6-9. the multi-bit path -------------------------------------------
    t0 = time.time()
    mb_launches, mb_cks, mb_sks = multibit_main_path(dev)
    t_main_mb = time.time() - t0
    multibit_card_vs_cpu(dev)
    multibit_timing(card, dev, mb_cks, mb_sks, rng)
    del mb_cks, mb_sks
    torch.cuda.empty_cache()

    # -- 10-12. boolean gates -----------------------------------------------
    t0 = time.time()
    bool_launches, bool_cks, bool_sks = boolean_main_path(dev)
    t_main_bool = time.time() - t0
    boolean_card_vs_cpu(dev)
    boolean_timing(card, dev, bool_cks, bool_sks, rng)
    for k, v in bool_launches.items():
        launches[k] = launches.get(k, 0) + v
    del bool_cks, bool_sks
    torch.cuda.empty_cache()

    # -- 13-17. the CRT-NTT key layout on K10, at 32, 64 and 128 bits -------
    t0 = time.time()
    ntt_launches = ntt_main_path(dev)
    t_main_ntt = time.time() - t0
    t0 = time.time()
    u128_launches, u128_state = u128_main_path(dev)
    t_main_u128 = time.time() - t0
    ntt_card_vs_cpu(dev)
    ntt_timing(card, dev, u128_state, rng)
    del u128_state
    torch.cuda.empty_cache()

    # each classic wrapper's largest error over both full widths; times
    # and bounds at its main path's width (B = 64): K1 and K2 at
    # PARAM_MESSAGE_2_CARRY_2_KS_PBS, the new schedules' kernels at boolean
    # DEFAULT_PARAMETERS (the persistent launch runs all 722 steps)
    errs = {k: max(w[0][k] for w in modes_k.values())
            for k in modes_k["DEFAULT_PARAMETERS"][0]}
    kernels = []
    for name, line, src, width in (
            ("rotate_decompose", 1229, "pbs_kernels.cuh", p.name),
            ("external_product_crt", 1244, "ntt_core_kernels.cuh", p.name),
            ("pbs_step", 1304, "ntt_core_kernels.cuh", "DEFAULT_PARAMETERS"),
            ("blind_rotate_persistent", 1020, "ntt_core_kernels.cuh",
             "DEFAULT_PARAMETERS"),
            ("ntt_mac_prime", 1503, "ntt_core_kernels.cuh",
             "DEFAULT_PARAMETERS"),
            ("crt_accumulate", 1520, "pbs_kernels.cuh", "DEFAULT_PARAMETERS"),
            ("pbs_step_single_cta", 983, "ntt_core_kernels.cuh",
             "DEFAULT_PARAMETERS"),
            ("blind_rotate_single_cta", 1403, "ntt_core_kernels.cuh",
             "DEFAULT_PARAMETERS")):
        _, ms, plain_ms, bounds = modes_k[width]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"tfhe_tpu_torch/ops/csrc/{src}",
            "replaces": f"tfhe_tpu/ops/fused_pbs.py:{line}",
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": ms[name], "plain_ms": plain_ms[name],
            "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
            "library_ms": None, "redesigned": REDESIGNED.get(name)})
    for name, line, src in (
            ("multibit_combine", 747, "multibit_kernels.cuh"),
            ("multibit_external_product", 823, "multibit_core.cuh"),
            ("multibit_step", 539, "multibit_core.cuh")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"tfhe_tpu_torch/ops/csrc/{src}",
            "replaces": f"tfhe_tpu/ops/fused_multibit.py:{line}",
            "launches": mb_launches[name], "max_abs_err": mb_err[name],
            "ms": mb_ms[name], "plain_ms": mb_plain_ms[name],
            "bound_ms": mb_bounds[name][0], "bound_by": mb_bounds[name][1],
            "library_ms": None, "redesigned": REDESIGNED.get(name)})
    # K10 as the main paths launch it: every prime of a step at once
    # (shoup_mac_primes), timed and bounded per step
    ntt_err, ntt_ms, ntt_plain_ms, ntt_bounds = ntt_k
    kernels.append({
        "name": "shoup_mac", "route": "cuda", "wrapper": "shoup_mac_primes",
        "source": "tfhe_tpu_torch/ops/csrc/shoup_mac_kernels.cuh",
        "replaces": "tfhe_tpu/ops/pallas_kernels.py:64",
        "launches": ntt_launches + u128_launches,
        "max_abs_err": max(ntt_err.values()), "ms": ntt_ms["shortint"],
        "plain_ms": ntt_plain_ms["shortint"],
        "bound_ms": ntt_bounds["shortint"][0],
        "bound_by": ntt_bounds["shortint"][1], "library_ms": None,
        "redesigned": REDESIGNED.get("shoup_mac")})
    say("done", t_start, main_path_s=round(t_main, 3),
        main_path_shortint_ops_s=round(t_ops, 3),
        main_path_pbs_ks_s=round(t_pbs_ks, 3),
        main_path_multibit_s=round(t_main_mb, 3),
        main_path_boolean_s=round(t_main_bool, 3),
        main_path_ntt_s=round(t_main_ntt, 3),
        main_path_u128_s=round(t_main_u128, 3))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
