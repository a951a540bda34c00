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
     for each batch), crt_accumulate at B=1, 3 and 256 too, and a
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
     many-LUT batch again in scan1w and mega, identical),
     main_path_integer on the same keys (the radix integer layer at 32
     blocks, a u64: add, sub, mul, bitxor, scalar_mul, scalar_left_shift,
     eq, lt, max, if_then_else, neg, the signed add and lt on seeded pairs
     with 0, 2^63 and 2^64 - 1 among them (the first pair's run cold),
     div_rem at 8 blocks, on basis [2, 3] a chain of four CRT adds (two
     carry-clearing PBS batches) and a CRT mul; every result decrypted right, each
     op's PBS batches and wall ms, n launches of K1 and of K2 per PBS
     batch),
     card_vs_cpu_integer (add, mul, lt at 4 blocks of
     PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST, card == CPU word for word),
     main_path_integer_fused (IntegerServerKey(fused=True) on the same keys
     and pairs at 32 blocks: add, sub, neg, mul, eq, lt, bitxor, select and
     max, each one CUDA graph captured at its first call and replayed after;
     per op the PBS batches of its chain beside the host schedule's, cold
     and warm ms beside the host schedule's, a replay's device time; every
     replay decrypted right and equal bit for bit to the chain run
     eagerly), main_path_batched (BatchedRadixOps, B = 64 integers of 8
     blocks: add, mul and lt in the "scan" and "ripple" carry schedules,
     ms and PBS waves each), main_path_strings (the string library on the
     same keys, 4 blocks a char: eq, contains, find, to_uppercase, trim,
     split, replace and nth_encrypted on strings of 8 to 16 characters and
     BatchedStringOps.contains over 64 texts, equal to Python's `str`, PBS
     batches and ms each, one run), card_vs_cpu_strings (eq, contains, find,
     to_uppercase, nth_encrypted and the compact push_padding_to_end at
     PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST, card == CPU word for word), and
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
     at full width: PARAM_MESSAGE_2_CARRY_2_KS_PBS keys on the card, one
     LUT on 64 messages, and boolean DEFAULT_PARAMETERS, mux on 64 seeded
     bit triples (one LUT and one gate batch keep the smoke inside its
     watchdog; every gate runs in main_path_boolean); decrypted right,
     word for word equal to scan2 keys
     rebuilt from the same raw keys, K10 launched exactly n times per PBS
     batch and nothing else launched;
 15. main_path_u128: the u128 PBS at the PBS widths and noise of
     PARAM_MESSAGE_2_CARRY_2_KS_PBS (n=742, N=2048, k=1, base_log 23, one
     level): keygen on the card, the (3x+1) mod 4 LUT on 64 encryptions,
     decrypted right, n K10 launches per rotation;
 16. card_vs_cpu_ntt: mode="ntt" shortint and boolean at the TEST sets and
     the u128 PBS at tests/test_u128.py's toy size, card == CPU word for
     word (keys, ciphertexts, outputs);
 17. timing_ntt: PBS/s (gates/s) and batch ms at B=64 (one run, after
     the main paths ran these paths) for shortint mode="ntt", the u128 PBS and boolean mode="ntt", and a
     CUDA-event split of one step at B=64 into decomposition, forward NTT,
     K10 (one launch), inverse NTT and CRT;
 18. main_path_api (after main_path_strings): the high-level API at full
     width, generate_keys on the ConfigBuilder default
     (PARAM_MESSAGE_2_CARRY_2_KS_PBS) with fused=True, set_server_key,
     FheUint64 (32 blocks) +, -, *, scalar +, &, ^, scalar <<, eq, lt,
     max, FheBool.if_then_else, cast_into(FheUint32 / FheInt64), FheInt64
     lt and abs, FheUint8 div_rem; every result decrypted against Python's;
     keygen s, cold and warm ms, PBS batches and K1 / K2 launches; + and *
     again with fused=False, the same words, both latencies; then
     card_vs_cpu_api (API ops at PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST,
     card == CPU word for word);
 19. main_path_multibit_ntt (after timing_multibit): the GROUP_3 raw keys
     of main_path_multibit in mode="ntt" (the multi-bit CRT-NTT layout,
     torch ops a step), one LUT batch at B=64 equal word for word to the
     scan3 key's, decrypted right; prepare s, PBS/s, peak device MB;
 20. main_path_examples (its radix half after main_path_strings, its
     boolean half after timing_boolean): the dark market (one order book
     at 8 blocks) and three regex patterns on the main path's keys;
     SHA-256 (a 2-round compression and one schedule word) and Trivium
     (the full 1152-step warm-up, the first 64 keystream bits against the
     KAT FBE0BF265859051B, one transciphered word) on main_path_boolean's
     keys; `python -m tfhe_tpu_torch.examples.fhe_strings_cli aba a
     --real-params` as a subprocess (exit 0, 14 ops ok); each part
     decrypted against its clear function, its wall s and PBS (gate)
     batches.
 21. main_path_keys (after main_path_pbs_ks, on the main path's keys):
     the public key at PARAM_MESSAGE_2_CARRY_2_KS_PBS (131264 zero
     encryptions, 2.15 GB: keygen s, an encryption of B=64 in ms, decrypted,
     a LUT batch on it), the compact public key at
     PARAM_MESSAGE_2_CARRY_2_COMPACT_PK_KS_PBS (64 messages compact, then
     expanded), the compressed server key (its bytes beside the server
     key's, decompression s, a LUT batch; the CPU's decompression of its
     bytes gives the same raw keys), a ServerKey through safe_serialize and
     safe_deserialize (bytes, s each way, a LUT batch equal to the
     original key's), and through the API a FheUint8 under the public key
     and a compact FheUint64, all decrypted;
 22. main_path_wopbs (after timing): WOPBS_PARAM_MESSAGE_2_CARRY_2_KS_PBS
     keys with the pfpksk list (keygen s, MB), wopbs_batch on the 16
     packed values with an identity, a message and a full-domain LUT, and
     IntegerWopbsKey.wopbs on a 4-block radix ((3x + 5) mod 256), every
     output decrypted; ms of extraction, circuit bootstrap and vertical
     packing, PBS batches, CMuxes, and K1 and K2 launches (above zero);
 23. kernels_wide: a LUT batch (B=8) at PARAM_4_BITS_5_BLOCKS (L*G = 18),
     at WOPBS_PARAM_MESSAGE_1_NORM2_6_KS_PBS (L*G = 12) and at
     main_path_wopbs's WOPBS_PARAM_MESSAGE_2_CARRY_2_KS_PBS (L*G = 4,
     N = 2048), decrypted and identical in all six classic modes; K1 and
     every classic kernel on the core (K2, ntt_mac_prime, K3, K4, K5 and K7
     over 4 steps) at the three widths against their plain versions
     (tolerance 0); K2's 18-digit
     variant's device ms and bound at B=64; a WoPBS at
     PARAM_4_BITS_5_BLOCKS on its 16 values, decrypted;
 24. card_vs_cpu_wopbs: a WoPBS at WOPBS_PARAM_MESSAGE_2_CARRY_2_TEST on
     the card and on the CPU from one seed, identical words.
 25. main_path_parallel (after main_path_integer_fused, on the main path's
     keys): parallel/ on a one-rank NCCL group (create_mesh() -> (1, 1)),
     shard_server_key, the batch-sharded keyswitch + PBS of 64 messages,
     the batch-sharded add (B = 4) and mul (B = 2) of u64s (32 blocks),
     the batch-sharded strings contains over 8 texts and the block-sharded
     add (B = 4, 32 blocks); each decrypted right and equal word for word
     to the unsharded chain, with its PBS batches, cold and warm ms, K1
     and K2 launches (n a PBS batch) and point-to-point ops (0 at one
     rank); with two cards or more, the block- and batch-sharded adds on
     two NCCL ranks too; `ranks` lists the world sizes run; the group is
     destroyed at the end;
 26. checkpoint_resume: ResumableBatchRunner over 256 ciphertexts in
     chunks of 64 on the card, a failure injected after chunk 2, a fresh
     runner that resumes and runs only the remaining chunk, equal to an
     uninterrupted run; the CPU's load of a chunk's file equal to the
     card's words; ms per save and per load;
 27. profiling: utils.trace around one B=64 LUT batch: the K1 and K2
     kernel events in the trace equal to the wrappers' launch counters
     (n each), and the traced device-busy share of the batch.
Kernel times are device times: a CUDA graph of many launches replayed
between CUDA events (a whole rotation, persistent or single-CTA: CUDA events
around a few eager launches); the eager per-launch times beside them include
the host's launch cost.
Then a `kernels` JSON line (each kernel's `redesigned` names the source
it was rebuilt on after its first port: K2, K3, K4, K5, ntt_mac_prime, K7
and K9 on the register-resident NTT core, K10, K8's combine, K1 and
crt_accumulate in their own files), the nvidia-smi
line, and as the last line {"ok": true, "device": {...}}.  Any failed phase
raises, so the script exits non-zero and prints no result; it needs a card
and refuses to run without one.  A watchdog ends a hung run with a
traceback.
"""

import dataclasses
import faulthandler
import json
import os
import subprocess
import sys
import tempfile
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
# combine (a key tile in shared memory), K1 and K6's crt_accumulate (4
# words a thread; the CRT the core's explicit one) in their own files
REDESIGNED = dict.fromkeys(("external_product_crt", "pbs_step",
                            "pbs_step_single_cta", "blind_rotate_persistent",
                            "ntt_mac_prime", "blind_rotate_single_cta",
                            "multibit_external_product", "multibit_step"),
                           "tfhe_tpu_torch/ops/csrc/ntt_core.cuh")
REDESIGNED["shoup_mac"] = "tfhe_tpu_torch/ops/csrc/shoup_mac_kernels.cuh"
REDESIGNED["multibit_combine"] = (
    "tfhe_tpu_torch/ops/csrc/multibit_kernels.cuh")
REDESIGNED["rotate_decompose"] = "tfhe_tpu_torch/ops/csrc/pbs_kernels.cuh"
REDESIGNED["crt_accumulate"] = "tfhe_tpu_torch/ops/csrc/pbs_kernels.cuh"


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
        # K6's crt_accumulate at B = 256 on those residues, and at B = 1
        # and 3 on the first ciphertexts of the B = 64 step's
        err_l["crt_accumulate"] = max_abs_err(
            fp.crt_accumulate(res_lp, acc_l, bits),
            fp.crt_accumulate_plain(res_lp, acc_l, bits))
        crt_small = {f"B{B}": max_abs_err(
            fp.crt_accumulate(res_p[:B], acc[:B], bits),
            fp.crt_accumulate_plain(res_p[:B], acc[:B], bits))
            for B in (1, 3)}
        # K3 and K4 run the same kernel, which this names for each batch
        k4_form = {f"B{B}": fp.pbs_step_single_cta_form(B, N, G, L, bits)
                   for B in (B_MAIN, B_LARGE)}
        if (any(err.values()) or any(err_rot.values())
                or any(k7_err.values()) or any(k5_err.values())
                or any(err_l.values()) or any(crt_small.values())):
            raise AssertionError(
                f"{p.name}: classic kernels disagree with their plain "
                f"versions: {err}, {steps}-step rotation per mode {err_rot}, "
                f"K7 at depth {n} {k7_checked}, K5 {k5_checked}, "
                f"B = {B_LARGE} {err_l}, crt_accumulate {crt_small}")
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
            max_abs_err_b256=err_l, crt_accumulate_max_abs_err=crt_small,
            pbs_step_single_cta_kernel=k4_form,
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


def integer_main_path(cks, sks):
    """The radix integer layer (tfhe_tpu_torch.integer, host schedules) on
    the main path's PARAM_MESSAGE_2_CARRY_2_KS_PBS keys at 32 blocks (a u64,
    the FheUint64 width at 2_2): add, sub, mul, bitxor, scalar_mul,
    scalar_left_shift, eq, lt, max, if_then_else, neg and the signed add
    and lt on seeded pairs with 0, 2^63 and 2^64 - 1 among them; div_rem
    at 8 blocks; on basis [2, 3] a chain of four CRT adds (the third
    clears both operands' carries, a PBS batch each: a single add of fresh
    blocks is linear and launches nothing) and a CRT mul.  Each op runs
    once a pair; the first pair's run, the op's first, is kept apart as
    `cold_ms`.  Every result decrypted and equal to the clear one; each
    op's PBS batches and wall ms per call (host clock, synchronised; one
    entry a pair); K1 and K2 launched exactly n times per PBS batch
    (scan2), warm-up included, nothing else launched.  Returns the
    launches."""
    import numpy as np
    import torch

    from tfhe_tpu_torch import integer
    from tfhe_tpu_torch.ops import fused_pbs as fp

    t0 = time.time()
    p, nb = sks.params, 32
    n, mod = p.lwe_dimension, p.message_modulus ** nb
    rng = np.random.default_rng(SEED + 14)

    def u64():
        return int.from_bytes(rng.bytes(8), "little")

    # two pairs (three, with (2^63, 2^64 - 1), until the parallel,
    # checkpoint and profiling phases needed the smoke's time)
    pairs = [(0, 2**64 - 1), (2**63, u64())]
    scalar = 0x9E3779B97F4A7C15
    fp.reset_launch_counts()
    counted, calls = counting_pbs(sks)
    rck = integer.RadixClientKey(p, nb, _key=cks)
    isk = integer.IntegerServerKey(counted)
    signed = lambda v: v - mod if v >= mod // 2 else v  # noqa: E731
    ops = {  # name: (the op on ciphertexts, the clear result, decryption)
        "add": (lambda a, b, c: isk.add_parallelized(a, b),
                lambda x, y: (x + y) % mod, "decrypt"),
        "sub": (lambda a, b, c: isk.sub_parallelized(a, b),
                lambda x, y: (x - y) % mod, "decrypt"),
        "mul": (lambda a, b, c: isk.mul_parallelized(a, b),
                lambda x, y: x * y % mod, "decrypt"),
        "bitxor": (lambda a, b, c: isk.bitxor_parallelized(a, b),
                   lambda x, y: x ^ y, "decrypt"),
        "scalar_mul": (lambda a, b, c: isk.scalar_mul_parallelized(a, scalar),
                       lambda x, y: x * scalar % mod, "decrypt"),
        "scalar_left_shift": (
            lambda a, b, c: isk.scalar_left_shift_parallelized(a, 13),
            lambda x, y: (x << 13) % mod, "decrypt"),
        "eq": (lambda a, b, c: isk.eq_parallelized(a, b),
               lambda x, y: x == y, "decrypt_bool"),
        "lt": (lambda a, b, c: isk.lt_parallelized(a, b),
               lambda x, y: x < y, "decrypt_bool"),
        "max": (lambda a, b, c: isk.max_parallelized(a, b), max, "decrypt"),
        "if_then_else": (lambda a, b, c: isk.if_then_else_parallelized(c, a,
                                                                       b),
                         lambda x, y: x if x % 3 else y, "decrypt"),
        "neg": (lambda a, b, c: isk.neg_parallelized(a),
                lambda x, y: -x % mod, "decrypt"),
        "signed_add": (lambda a, b, c: isk.add_parallelized(a, b),
                       lambda x, y: signed((x + y) % mod), "decrypt_signed"),
        "signed_lt": (lambda a, b, c: isk.signed_cmp_parallelized(a, b, "lt"),
                      lambda x, y: signed(x) < signed(y), "decrypt_bool"),
    }
    batches, wall_ms, cold_ms, cold_batches, wrong = {}, {}, {}, [0], []

    def run(name, fn, want, dec, cold=False):
        """fn() timed and its PBS batches counted, one entry per call under
        `name` (an op's first call's ms under cold_ms, its batches only in
        the total); dec decrypts each of its results."""
        torch.cuda.synchronize()
        calls[0] = 0
        t = time.time()
        out = fn()
        torch.cuda.synchronize()
        (cold_ms if cold else wall_ms).setdefault(name, []).append(
            (time.time() - t) * 1e3)
        if cold:
            cold_batches[0] += calls[0]
        else:
            batches.setdefault(name, []).append(calls[0])
        got = tuple(map(dec, out)) if isinstance(out, tuple) else dec(out)
        if got != want:
            wrong.append((name, str(got), str(want)))

    # the first pair's run is each op's first, its cold one (a separate
    # warm-up run on it was cut when the parallel, checkpoint and
    # profiling phases needed the smoke's time)
    for i, (x, y) in enumerate(pairs):
        enc = {False: (rck.encrypt(x), rck.encrypt(y)),
               True: (rck.encrypt_signed(signed(x)),
                      rck.encrypt_signed(signed(y)))}
        cond = rck.encrypt_bool(bool(x % 3))
        for name, (fn, clear, how) in ops.items():
            a, b = enc[name.startswith("signed")]
            run(name, lambda: fn(a, b, cond),  # noqa: B023
                clear(x, y), getattr(rck, how), cold=i == 0)
    # div_rem at 8 blocks (a u16), and a CRT add and mul on basis [2, 3]
    x, y = u64() % 2**16, u64() % 2**8 + 1
    a, b = rck.encrypt(x, 8), rck.encrypt(y, 8)
    run("div_rem_8_blocks", lambda: isk.div_rem_parallelized(a, b),
        (x // y, x % y), rck.decrypt)
    crt_ck = integer.CrtClientKey(p, [2, 3], key=cks)
    crt_sk = integer.CrtServerKey(counted)
    a, b = crt_ck.encrypt(5), crt_ck.encrypt(3)

    def crt_add_chain():
        s = crt_sk.crt_add_parallelized(a, b)
        for _ in range(3):
            s = crt_sk.crt_add_parallelized(s, s)
        return s

    run("crt_add_x4", crt_add_chain, (5 + 3) * 8 % 6, crt_ck.decrypt)
    run("crt_mul", lambda: crt_sk.crt_mul_parallelized(a, b), 5 * 3 % 6,
        crt_ck.decrypt)
    launches = launched(fp.KERNELS)
    total = sum(map(sum, batches.values())) + cold_batches[0]
    say("main_path_integer", t0, params=p.name, num_blocks=nb,
        pairs=[[str(v) for v in pr] for pr in pairs], scalar=str(scalar),
        pbs_batches=batches, wall_ms=wall_ms, cold_ms=cold_ms,
        cold_pbs_batches=cold_batches[0], wrong=wrong,
        launches=launches)
    if batches["crt_add_x4"] != [2]:
        raise AssertionError(f"the CRT add chain ran "
                             f"{batches['crt_add_x4']} PBS batches, not 2")
    if wrong:
        raise AssertionError(f"radix ops wrong: {wrong}")
    want_l = {k: v * total for k, v in rotation_launches("scan2", n).items()}
    if launches != want_l:
        raise AssertionError(f"integer ops launched {launches}, expected "
                             f"{want_l} ({total} PBS batches)")
    return launches, wall_ms, batches


def integer_card_vs_cpu():
    """add, mul and lt on 4-block radix integers at
    PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST, keys from one seed on the card and
    on the CPU: the same blocks, degrees and noise levels, word for word."""
    import numpy as np

    from tfhe_tpu_torch import integer
    from tfhe_tpu_torch.params import PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST

    t0 = time.time()
    outs = {}
    for where in ("cuda", "cpu"):
        rck, isk = integer.gen_keys_radix(PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST,
                                          4, seed=SEED, device=where)
        a, b = rck.encrypt(201), rck.encrypt(77)
        res = {"add": isk.add_parallelized(a, b),
               "mul": isk.mul_parallelized(a, b),
               "lt": isk.lt_parallelized(a, b)}
        got = (rck.decrypt(res["add"]), rck.decrypt(res["mul"]),
               rck.decrypt_bool(res["lt"]))
        if got != ((201 + 77) % 256, 201 * 77 % 256, False):
            raise AssertionError(f"{where}: radix ops wrong: {got}")
        outs[where] = {k: v.blocks if k != "lt" else v.block
                       for k, v in res.items()}
    same = {k: bool(np.array_equal(c.data.cpu().numpy(),
                                   outs["cpu"][k].data.numpy())
                    and np.array_equal(c.degrees, outs["cpu"][k].degrees)
                    and np.array_equal(c.noise, outs["cpu"][k].noise))
            for k, c in outs["cuda"].items()}
    say("card_vs_cpu_integer", t0,
        params=PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST.name, num_blocks=4,
        identical=same)
    if not all(same.values()):
        raise AssertionError(f"radix ops on the card and the CPU differ: "
                             f"{same}")


# the single-program ops the fused phase drives, by the name of their
# FusedIntegerOps program: (the IntegerServerKey call, the clear result,
# the decryption, the host schedule's op in main_path_integer)
FUSED_OPS = {
    "add": (lambda k, a, b, c: k.add_parallelized(a, b),
            lambda x, y, m: (x + y) % m, "decrypt", "add"),
    "sub": (lambda k, a, b, c: k.sub_parallelized(a, b),
            lambda x, y, m: (x - y) % m, "decrypt", "sub"),
    "neg": (lambda k, a, b, c: k.neg_parallelized(a),
            lambda x, y, m: -x % m, "decrypt", "neg"),
    "mul": (lambda k, a, b, c: k.mul_parallelized(a, b),
            lambda x, y, m: x * y % m, "decrypt", "mul"),
    "eq": (lambda k, a, b, c: k.eq_parallelized(a, b),
           lambda x, y, m: x == y, "decrypt_bool", "eq"),
    "lt": (lambda k, a, b, c: k.lt_parallelized(a, b),
           lambda x, y, m: x < y, "decrypt_bool", "lt"),
    "bxor": (lambda k, a, b, c: k.bitxor_parallelized(a, b),
             lambda x, y, m: x ^ y, "decrypt", "bitxor"),
    "select": (lambda k, a, b, c: k.if_then_else_parallelized(c, a, b),
               lambda x, y, m: x if x % 3 else y, "decrypt",
               "if_then_else"),
    "max": (lambda k, a, b, c: k.max_parallelized(a, b),
            lambda x, y, m: max(x, y), "decrypt", "max"),
}


def integer_fused_main_path(cks, sks, host_ms, host_batches):
    """The single-program radix schedule (IntegerServerKey(fused=True):
    each op one CUDA graph, captured at its first call and replayed) on the
    main path's PARAM_MESSAGE_2_CARRY_2_KS_PBS keys in scan2, at 32 blocks
    on main_path_integer's pairs: add, sub, neg, mul, eq, lt, bitxor,
    select and max.  Per op: the PBS batches of its chain (K1 launches per
    rotation in the capture; beside them the host schedule's), the cold ms
    (the eager warm-up, the capture and the first replay) and the warm ms
    of each later replay (host clock, synchronised), beside the host
    schedule's ms from main_path_integer, and the device time of a replay
    (CUDA events around 3 back-to-back replays); every replay decrypted
    right and equal bit for bit to the same chain run eagerly on the card.
    Returns the launches: the counters' (the warm-ups, the captures and
    the eager runs) less the captures, plus each capture's launches per
    replay."""
    import numpy as np
    import torch

    from tfhe_tpu_torch import integer
    from tfhe_tpu_torch.ops import fused_pbs as fp

    t0 = time.time()
    p, nb = sks.params, 32
    n, mod = p.lwe_dimension, p.message_modulus ** nb
    rng = np.random.default_rng(SEED + 14)

    def u64():
        return int.from_bytes(rng.bytes(8), "little")

    # two pairs (three, with (2^63, 2^64 - 1), until the parallel,
    # checkpoint and profiling phases needed the smoke's time)
    pairs = [(0, 2**64 - 1), (2**63, u64())]
    rck = integer.RadixClientKey(p, nb, _key=cks)
    isk = integer.IntegerServerKey(sks, fused=True)
    fp.reset_launch_counts()
    batches, cold_ms, warm_ms, wrong, not_eager = {}, {}, {}, [], []
    captured, replays = {}, {}
    for i, (x, y) in enumerate(pairs):
        a, b = rck.encrypt(x), rck.encrypt(y)
        cond = rck.encrypt_bool(bool(x % 3))
        for name, (fn, clear, how, _) in FUSED_OPS.items():
            before = fp.rotate_decompose.launches
            torch.cuda.synchronize()
            t = time.time()
            out = fn(isk, a, b, cond)
            torch.cuda.synchronize()
            dt = (time.time() - t) * 1e3
            if i == 0:  # warm-up, capture, first replay
                cold_ms[name] = dt
                # the warm-up and the capture each count the chain once
                batches[name] = (fp.rotate_decompose.launches - before) \
                    // (2 * n)
            else:
                warm_ms.setdefault(name, []).append(dt)
            replays[name] = replays.get(name, 0) + 1
            got = getattr(rck, how)(out)
            if got != clear(x, y, mod):
                wrong.append((name, str(got), str(clear(x, y, mod))))
            args = [v.block if hasattr(v, "block") else v.blocks for v in
                    ((cond, a, b) if name == "select" else
                     (a,) if name == "neg" else (a, b))]
            eager = isk._fused_ops.try_op(name, *args, graph=False)
            res = out.block if hasattr(out, "block") else out.blocks
            if not torch.equal(res.data, eager.data):
                not_eager.append((name, i))
    graphs = sorted({k[0] for k in isk._fused_ops._graphs})
    counted = launched(fp.KERNELS)
    # each graph's device time: CUDA events around 3 replays of its last
    # inputs (nothing on the host between them)
    device_ms = {}
    for (name, _), (_, graph, _) in isk._fused_ops._graphs.items():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        device_ms[name] = start.elapsed_time(end) / 3
        replays[name] += 3
    per_chain = {k: v * sum(batches.values()) for k, v in
                 rotation_launches("scan2", n).items()}
    # the counters hold one warm-up, one capture and one eager run a pair
    # and op; a capture launches nothing, each replay launches its chain
    launches = {k: counted.get(k, 0) + per_chain[k] * (len(pairs) + 2)
                for k in per_chain}
    say("main_path_integer_fused", t0, params=p.name, num_blocks=nb,
        mode=sks.mode, pairs=[[str(v) for v in pr] for pr in pairs],
        graphs=graphs, pbs_batches=batches,
        host_pbs_batches={k: host_batches[v[3]][0]
                          for k, v in FUSED_OPS.items()},
        cold_ms=cold_ms, warm_ms=warm_ms, device_ms=device_ms,
        host_wall_ms={k: host_ms[v[3]] for k, v in FUSED_OPS.items()},
        replays=replays, wrong=wrong, replay_differs_from_eager=not_eager,
        launches=launches)
    if wrong or not_eager or graphs != sorted(FUSED_OPS):
        raise AssertionError(f"fused radix ops: wrong {wrong}, replay != "
                             f"eager {not_eager}, graphs {graphs}")
    want = {k: v * sum(batches.values()) * (2 + len(pairs)) for k, v in
            rotation_launches("scan2", n).items()}
    if counted != want:
        raise AssertionError(f"fused radix ops counted {counted}, expected "
                             f"{want}")
    return launches


PARALLEL_TEXTS = ("homomorphic", "ciphertexts", "bootstrapping",
                  "blind rotation", "key switching", "lookup tables",
                  "graph of hops", "alphabet soup")
PARALLEL_PATTERN = "ph"
PARALLEL_BLOCKS = 32  # a u64


def radix_value(cks, row, msg):
    """The clear value of radix blocks [nb, lwe] (least significant
    first)."""
    return sum(int(d) * msg**j for j, d in enumerate(cks.decrypt_batch(row)))


def parallel_rank(rank, store, a, b, seed, out_dir):
    """One of two NCCL ranks (card `rank`) of main_path_parallel: keys from
    seed + rank (shard_server_key makes rank 0's every rank's), the
    block-sharded add over both ranks and the batch-sharded add, rank 1
    handing `place` zeros; each rank writes the gathered words."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from tfhe_tpu_torch import parallel, shortint
    from tfhe_tpu_torch.params import PARAM_MESSAGE_2_CARRY_2_KS_PBS

    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"file://{store}",
                            world_size=2, rank=rank)
    try:
        _, sks = shortint.gen_keys(PARAM_MESSAGE_2_CARRY_2_KS_PBS,
                                   seed=seed + rank, device="cuda")
        if rank:
            a, b = np.zeros_like(a), np.zeros_like(b)
        nb = a.shape[1]
        for name, (step, place) in (
                ("blockshard", parallel.make_blockshard_radix_add(
                    parallel.create_mesh((2,), ("batch",)), sks, nb)),
                ("batch", parallel.make_sharded_radix_add(
                    parallel.create_mesh((2, 1)), sks, nb))):
            out = step(place(a), place(b)).full_tensor()
            np.save(f"{out_dir}/{name}_{rank}.npy",
                    out.cpu().numpy().view(np.uint64))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def parallel_two_ranks(a, b, want, workdir):
    """The block- and batch-sharded adds on two NCCL ranks, one spawned
    process a card: every rank's words equal `want` (the unsharded add's
    on one card).  Returns the ms from spawn to join."""
    import numpy as np
    import torch.multiprocessing as mp

    from tfhe_tpu_torch.ops.torus import to_numpy

    t = time.time()
    mp.start_processes(parallel_rank,
                       args=(f"{workdir}/store", to_numpy(a), to_numpy(b),
                             SEED, workdir),
                       nprocs=2, start_method="spawn", join=True)
    ms = (time.time() - t) * 1e3
    want = to_numpy(want)
    for name in ("blockshard", "batch"):
        for rank in range(2):
            got = np.load(f"{workdir}/{name}_{rank}.npy")
            if not np.array_equal(got, want):
                raise AssertionError(f"two NCCL ranks: the {name}-sharded "
                                     f"add on rank {rank} differs")
    return ms


def parallel_main_path(cks, sks, workdir):
    """parallel/ at full width on the main path's PARAM_MESSAGE_2_CARRY_2_
    KS_PBS keys (scan2): a one-rank NCCL group on a private store and
    create_mesh() -> (1, 1) over ("batch", "poly"); shard_server_key (the
    words kept); then, each on DTensors from `place` / shard_batch, the
    batch-sharded keyswitch + PBS of 64 messages, the batch-sharded add of
    B = 4 and mul of B = 2 u64s (32 blocks), the batch-sharded strings
    contains over 8 texts of 11-14 chars and the block-sharded add of the
    same B = 4 u64s; each decrypted against Python and equal word for word
    to the unsharded chain (integer.fused) on the same inputs.  Per op: PBS
    batches (K1 launches / n), cold and warm ms (host clock, synchronised),
    K1 and K2 launches of one run (n a PBS batch, as many as the unsharded
    chain's, nothing else launched) and point-to-point ops (0 at one
    rank).  With two cards or more, two NCCL ranks run the block- and
    batch-sharded adds too, with equal words.  The group is destroyed at
    the end.  Returns the launches of the sharded runs."""
    import functools

    import numpy as np
    import torch
    import torch.distributed as dist

    from tfhe_tpu_torch import integer, parallel
    from tfhe_tpu_torch.core import keyswitch_then_pbs
    from tfhe_tpu_torch.ops import fused_pbs as fp
    from tfhe_tpu_torch.parallel import fused as PF
    from tfhe_tpu_torch.parallel.sharding import batch_spec
    from tfhe_tpu_torch.strings import NUMBER_BLOCKS

    t0 = time.time()
    p, nb = sks.params, PARALLEL_BLOCKS
    n, msg = p.lwe_dimension, p.message_modulus
    mod = msg ** nb
    rng = np.random.default_rng(SEED + 18)
    mesh = parallel.create_mesh()
    if (dist.get_backend() != "nccl" or tuple(mesh.shape) != (1, 1)
            or mesh.mesh_dim_names != ("batch", "poly")):
        raise AssertionError(f"mesh {mesh} on {dist.get_backend()}")
    t = time.time()
    bsk, ksk = parallel.shard_server_key(mesh, sks.bsk, sks.ksk)
    torch.cuda.synchronize()
    key_ms = (time.time() - t) * 1e3
    if not (torch.equal(bsk.kspec, sks.bsk.kspec)
            and torch.equal(bsk.kshoup, sks.bsk.kshoup)
            and torch.equal(ksk.matrix, sks.ksk.matrix)):
        raise AssertionError("shard_server_key changed the key's words")

    def u64():
        return int.from_bytes(rng.bytes(8), "little")

    rck = integer.RadixClientKey(p, nb, _key=cks)

    def radix(vals):
        return torch.stack([rck.encrypt(v).blocks.data for v in vals])

    launches, ops, wrong, differs, bad_counts = {}, {}, [], [], []

    def run(name, step, args, unsharded, check):
        fp.reset_launch_counts()
        PF.reset_p2p_counts()
        torch.cuda.synchronize()
        t = time.time()
        out = step(*args).full_tensor()
        torch.cuda.synchronize()
        cold_ms = (time.time() - t) * 1e3
        counts = launched(fp.KERNELS)
        p2p = PF._shift_up_collective.p2p_ops
        t = time.time()
        again = step(*args).full_tensor()
        torch.cuda.synchronize()
        warm_ms = (time.time() - t) * 1e3
        for k, v in launched(fp.KERNELS).items():
            launches[k] = launches.get(k, 0) + v
        fp.reset_launch_counts()
        want = unsharded()
        torch.cuda.synchronize()
        plain_counts = launched(fp.KERNELS)
        k1 = counts.get("rotate_decompose", 0)
        ops[name] = dict(pbs_batches=k1 // n, cold_ms=cold_ms,
                         warm_ms=warm_ms, k1_launches=k1,
                         k2_launches=counts.get("external_product_crt", 0),
                         p2p_ops=p2p)
        if not (torch.equal(out, want) and torch.equal(again, out)):
            differs.append(name)
        if (counts != {"rotate_decompose": k1, "external_product_crt": k1}
                or not k1 or k1 % n or counts != plain_counts or p2p):
            bad_counts.append((name, counts, plain_counts, p2p))
        if not check(out):
            wrong.append(name)
        return out

    # the keyswitch + PBS of 64 messages, the batch on the batch axis
    msgs = np.arange(B_MAIN) % p.total_modulus
    cts = cks.encrypt_batch(msgs).data
    lut = sks.generate_lookup_table(lambda x: (3 * x + 1) % 16)
    step, _ = PF.bind_to_mesh(mesh, batch_spec(2), functools.partial(
        PF.fused_ks_pbs, ksk, bsk, lut.acc))
    run("ks_pbs", step, (parallel.shard_batch(mesh, cts),),
        lambda: keyswitch_then_pbs(sks.ksk, sks.bsk, lut.acc, cts),
        lambda out: np.array_equal(cks.decrypt_batch_message_and_carry(out),
                                   (3 * msgs + 1) % 16))

    xs = [0, 2**64 - 1, 2**63, u64()]
    ys = [2**64 - 1, 1, 2**63, u64()]
    a, b = radix(xs), radix(ys)
    sums = [(x + y) % mod for x, y in zip(xs, ys)]
    add_step, place = parallel.make_sharded_radix_add(mesh, sks, nb)
    add = run("sharded_add", add_step, (place(a), place(b)),
              lambda: add_step.chain(a, b),
              lambda out: [radix_value(cks, r, msg) for r in out] == sums)

    step, place = parallel.make_sharded_radix_mul(mesh, sks, nb)
    run("sharded_mul", step, (place(a[2:]), place(b[2:])),
        lambda: step.chain(a[2:], b[2:]),
        lambda out: [radix_value(cks, r, msg) for r in out]
        == [x * y % mod for x, y in zip(xs[2:], ys[2:])])

    width = max(len(s) for s in PARALLEL_TEXTS)
    chars = torch.stack([cks.encrypt_batch([
        (c // msg**d) % msg for c in [ord(ch) for ch in text]
        + [0] * (width - len(text)) for d in range(NUMBER_BLOCKS)]).data
        .reshape(width, NUMBER_BLOCKS, -1) for text in PARALLEL_TEXTS])
    step, place = parallel.make_sharded_strings_contains(
        mesh, sks, PARALLEL_PATTERN)
    run("sharded_strings_contains", step, (place(chars),),
        lambda: step.chain(chars),
        lambda out: cks.decrypt_batch(out).tolist()
        == [int(PARALLEL_PATTERN in s) for s in PARALLEL_TEXTS])

    step, place = parallel.make_blockshard_radix_add(
        parallel.create_mesh((1,), ("batch",)), sks, nb)
    run("blockshard_add", step, (place(a), place(b)),
        lambda: add_step.chain(a, b),
        lambda out: [radix_value(cks, r, msg) for r in out] == sums)

    ranks = [1]
    two_rank_ms = None
    if torch.cuda.device_count() >= 2:
        two_rank_ms = parallel_two_ranks(a, b, add, workdir)
        ranks.append(2)
    dist.destroy_process_group()
    say("main_path_parallel", t0, params=p.name, num_blocks=nb,
        mode=sks.mode, backend="nccl", mesh=[1, 1], ranks=ranks,
        shard_server_key_ms=key_ms, texts=list(PARALLEL_TEXTS),
        pattern=PARALLEL_PATTERN, ops=ops, two_rank_ms=two_rank_ms,
        wrong=wrong, differs_from_unsharded=differs, bad_counts=bad_counts,
        launches=launches)
    if wrong or differs or bad_counts or dist.is_initialized():
        raise AssertionError(f"parallel: wrong {wrong}, differs from the "
                             f"unsharded chain {differs}, counts "
                             f"{bad_counts}")
    return launches


def checkpoint_main_path(cks, sks, workdir):
    """ResumableBatchRunner over 256 ciphertexts in chunks of 64 on the
    card (one LUT batch a chunk) on the main path's keys: an uninterrupted
    run; a run whose fourth chunk fails (a failure injected after chunk 2,
    no retry); a fresh runner that resumes and runs only the remaining
    chunk, its result equal word for word to the uninterrupted run's and
    decrypted right; the CPU's deserialization of one chunk's file equal to
    the card's words.  ms per save and per load (host clock around the
    manager's calls; a save copies the chunk from the card, a load to it).
    Returns the launches (8 LUT batches)."""
    import numpy as np
    import torch

    from tfhe_tpu_torch.ops import fused_pbs as fp
    from tfhe_tpu_torch.parallel import CheckpointManager, ResumableBatchRunner
    from tfhe_tpu_torch.shortint.ciphertext import ShortintBatch

    t0 = time.time()
    p = sks.params
    total, chunk = 4 * B_MAIN, B_MAIN
    msgs = np.arange(total) % p.total_modulus
    data = cks.encrypt_batch(msgs).data
    lut = sks.generate_lookup_table(lambda x: (x + 5) % 16)
    save_ms, load_ms = [], []

    class Timed(CheckpointManager):
        def save(self, step, objects):
            t = time.time()
            super().save(step, objects)
            save_ms.append((time.time() - t) * 1e3)

        def load(self, step, device=None):
            t = time.time()
            out = super().load(step, device)
            torch.cuda.synchronize()
            load_ms.append((time.time() - t) * 1e3)
            return out

    def wrap(words):
        return ShortintBatch(
            data=words, degrees=np.full(words.shape[0], p.total_modulus - 1),
            message_modulus=p.message_modulus, carry_modulus=p.carry_modulus)

    calls = []

    def fn(fail_at=None):
        def lut_batch(words):
            calls.append(1)
            if len(calls) == fail_at:
                raise RuntimeError("injected device loss")
            return sks.apply_lookup_table_batch(wrap(words), lut).data
        return lut_batch

    fp.reset_launch_counts()
    whole = ResumableBatchRunner(Timed(f"{workdir}/whole"), chunk).run(
        fn(), data, wrap, lambda b: b.data)
    mgr = Timed(f"{workdir}/job")
    calls.clear()
    try:
        ResumableBatchRunner(mgr, chunk, max_retries=0).run(
            fn(fail_at=4), data, wrap, lambda b: b.data)
    except RuntimeError as e:
        if "injected" not in str(e):
            raise
    else:
        raise AssertionError("the injected failure did not stop the run")
    crashed_at = mgr.latest_step()
    calls.clear()
    out = ResumableBatchRunner(Timed(f"{workdir}/job"), chunk,
                               max_retries=0).run(fn(), data, wrap,
                                                  lambda b: b.data)
    torch.cuda.synchronize()
    resumed_chunks = len(calls)
    launches = launched(fp.KERNELS)
    cpu_chunk = CheckpointManager(f"{workdir}/job", device="cpu").load(
        1)["chunk"].data
    correct = int(np.sum(cks.decrypt_batch_message_and_carry(out)
                         == (msgs + 5) % 16))
    same_cpu = bool(torch.equal(cpu_chunk, out[chunk:2 * chunk].cpu()))
    say("checkpoint_resume", t0, params=p.name, ciphertexts=total,
        chunk=chunk, crashed_after_step=crashed_at,
        resumed_chunks=resumed_chunks, equal_to_uninterrupted=bool(
            torch.equal(out, whole)), correct=correct,
        cpu_load_equal=same_cpu, save_ms=save_ms, load_ms=load_ms,
        chunk_bytes=os.path.getsize(
            f"{workdir}/job/host0_step00000001/chunk.bin"),
        launches=launches)
    batches = 2 * total // chunk  # the uninterrupted run, 3 + 1 chunks
    want = {k: batches * v for k, v in
            rotation_launches("scan2", p.lwe_dimension).items()}
    if (crashed_at != 2 or resumed_chunks != 1 or not torch.equal(out, whole)
            or correct != total or not same_cpu or launches != want):
        raise AssertionError(f"checkpoint and resume failed (launches "
                             f"{launches}, expected {want})")
    return launches


def profiling_main_path(cks, sks, workdir):
    """utils.trace around one B = 64 LUT batch on the main path's keys (an
    annotated region that ends in a synchronise, after a warm-up): the K1
    and K2 kernel events (rotate_decompose_kernel,
    external_product_cluster_kernel) in the Chrome trace it writes against
    the wrappers' launch counters (n each), their summed device ms, and the
    device-busy share of the region: the union of the trace's kernel,
    memcpy and memset intervals over the region's span.  Returns the
    launches."""
    import glob

    import numpy as np
    import torch

    from tfhe_tpu_torch.ops import fused_pbs as fp
    from tfhe_tpu_torch.utils import annotate, trace

    t0 = time.time()
    n = sks.params.lwe_dimension
    batch = cks.encrypt_batch(np.arange(B_MAIN) % 16)
    lut = sks.generate_lookup_table(lambda x: (x * 7) % 16)
    sks.apply_lookup_table_batch(batch, lut)  # warm-up
    torch.cuda.synchronize()
    fp.reset_launch_counts()
    logdir = f"{workdir}/trace"
    with trace(logdir):
        with annotate("lut_batch_b64"):
            sks.apply_lookup_table_batch(batch, lut)
            torch.cuda.synchronize()
    counts = launched(fp.KERNELS)
    (path,) = glob.glob(f"{logdir}/*.pt.trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    (region,) = [e for e in events if e.get("name") == "lut_batch_b64"
                 and e.get("cat") == "user_annotation"]
    lo, hi = region["ts"], region["ts"] + region["dur"]
    device = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, lo
    for s, e in device:  # the union of the device intervals in the region
        s, e = max(s, end), min(e, hi)
        if e > s:
            busy += e - s
            end = e
    kernels = {"rotate_decompose": "rotate_decompose_kernel",
               "external_product_crt": "external_product_cluster_kernel"}
    traced = {k: [e["dur"] for e in events if e.get("cat") == "kernel"
                  and v in e.get("name", "")] for k, v in kernels.items()}
    say("profiling", t0, params=sks.params.name, batch=B_MAIN,
        trace_bytes=os.path.getsize(path), region_ms=(hi - lo) / 1e3,
        device_busy_ms=busy / 1e3, device_busy_share=busy / (hi - lo),
        device_events=len(device),
        traced_launches={k: len(v) for k, v in traced.items()},
        traced_device_ms={k: sum(v) / 1e3 for k, v in traced.items()},
        counted_launches=counts)
    want = {k: n for k in kernels}
    if counts != want or {k: len(v) for k, v in traced.items()} != want:
        raise AssertionError(
            f"the trace holds {[len(v) for v in traced.values()]} K1 / K2 "
            f"events, the counters {counts}; expected {want}")
    return counts


def batched_main_path(cks, sks):
    """BatchedRadixOps on the main path's keys: B = 64 radix integers of 8
    blocks, add, mul and lt in both carry schedules ("scan" and "ripple"),
    each op once cold and once timed (host clock, synchronised), its PBS
    waves counted; every result decrypted right.  Returns the launches."""
    import numpy as np
    import torch

    from tfhe_tpu_torch import integer
    from tfhe_tpu_torch.integer.batched import (BatchedRadixOps,
                                                decrypt_batch_radix,
                                                encrypt_batch_radix)
    from tfhe_tpu_torch.ops import fused_pbs as fp

    t0 = time.time()
    p, nb, B = sks.params, 8, B_MAIN
    n, mod = p.lwe_dimension, p.message_modulus ** nb
    rng = np.random.default_rng(SEED + 15)
    av = rng.integers(0, mod, B).tolist()
    bv = rng.integers(0, mod, B).tolist()
    av[:2], bv[:2] = [mod - 1, mod - 1], [1, mod - 1]  # carry chains
    rck = integer.RadixClientKey(p, nb, _key=cks)
    a, b = encrypt_batch_radix(rck, av, nb), encrypt_batch_radix(rck, bv, nb)
    fp.reset_launch_counts()
    counted, calls = counting_pbs(sks)
    clear = {"add": lambda x, y: (x + y) % mod,
             "mul": lambda x, y: x * y % mod, "lt": lambda x, y: int(x < y)}
    ms, waves, wrong = {}, {}, []
    for mode in ("scan", "ripple"):
        ops = BatchedRadixOps(counted, mode)
        for name, f in clear.items():
            for cold in (True, False):
                torch.cuda.synchronize()
                calls[0] = 0
                t = time.time()
                out = getattr(ops, name)(a, b)
                torch.cuda.synchronize()
                if not cold:
                    ms[f"{name}_{mode}"] = (time.time() - t) * 1e3
                    waves[f"{name}_{mode}"] = calls[0]
            got = (rck.key.decrypt_batch(out).tolist() if name == "lt"
                   else decrypt_batch_radix(rck, out))
            if got != [f(x, y) for x, y in zip(av, bv)]:
                wrong.append(f"{name}_{mode}")
    launches = launched(fp.KERNELS)
    say("main_path_batched", t0, params=p.name, batch=B, num_blocks=nb,
        wall_ms=ms, pbs_waves=waves, wrong=wrong, launches=launches)
    if wrong:
        raise AssertionError(f"batched radix ops wrong: {wrong}")
    want = {k: v * 2 * sum(waves.values()) for k, v in
            rotation_launches("scan2", n).items()}
    if launches != want:
        raise AssertionError(f"batched ops launched {launches}, expected "
                             f"{want}")
    return launches


def strings_main_path(cks, sks):
    """The string library on the main path's PARAM_MESSAGE_2_CARRY_2_KS_PBS
    keys (4 blocks a char, no second keygen): eq, contains, find,
    to_uppercase, trim, split, replace and nth_encrypted on strings of 8 to
    16 characters, and BatchedStringOps.contains over 64 texts of up to 16;
    each op run once and timed (host clock, synchronised; a second, warm
    run was cut when the parallel, checkpoint and profiling phases needed
    the smoke's time: no string op captures a graph, so the two read
    alike), its PBS batches counted; every result equal to Python's
    `str`.  Returns the launches."""
    import numpy as np
    import torch

    from tfhe_tpu_torch import integer, strings
    from tfhe_tpu_torch.ops import fused_pbs as fp
    from tfhe_tpu_torch.strings.batched import (BatchedStringOps,
                                                encrypt_batch_strings)

    t0 = time.time()
    p, n = sks.params, sks.params.lwe_dimension
    fp.reset_launch_counts()
    counted, calls = counting_pbs(sks)
    scks = strings.StringClientKey(
        integer.RadixClientKey(p, strings.NUMBER_BLOCKS, _key=cks))
    ssks = strings.StringServerKey(integer.IntegerServerKey(counted))
    ik = scks.integer_key
    text = "Hello, World"
    enc = scks.encrypt_str
    h = enc(text)
    padded = scks.encrypt_str_padding("  hi there ", 2)
    rng = np.random.default_rng(SEED + 16)
    words = ["".join(chr(c) for c in rng.integers(97, 100, rng.integers(
        8, 17))) for _ in range(B_MAIN)]
    blocks = encrypt_batch_strings(scks, words, 16)
    bops = BatchedStringOps(counted)
    cases = {  # name: (the op, its decryption, Python's result)
        "eq": (lambda: ssks.eq(h, "Hello, World"), ik.decrypt_bool, True),
        "contains": (lambda: ssks.contains(h, "World"), ik.decrypt_bool,
                     True),
        "find": (lambda: ssks.find(h, "o"),
                 lambda r: (ik.decrypt_bool(r[0]), ik.decrypt(r[1])),
                 (True, text.find("o"))),
        "to_uppercase": (lambda: ssks.to_uppercase(h), scks.decrypt_string,
                         text.upper()),
        "trim": (lambda: ssks.trim(padded), scks.decrypt_string, "hi there"),
        "split": (lambda: ssks.split(enc("alpha,beta"), ","),
                  scks.decrypt_split, "alpha,beta".split(",")),
        "replace": (lambda: ssks.replace(enc("a-b-c-d-e"), "-", "+"),
                    scks.decrypt_string, "a-b-c-d-e".replace("-", "+")),
        "nth_encrypted": (lambda: ssks.nth_encrypted(h, ik.encrypt(7)),
                          scks.decrypt_ascii_char, ord(text[7])),
        "batched_contains_64": (
            lambda: bops.contains(blocks, "ab"),
            lambda r: ik.key.decrypt_batch(r).tolist(),
            [int("ab" in w) for w in words]),
    }
    ms, pbs_batches, wrong = {}, {}, []
    for name, (fn, dec, want) in cases.items():
        torch.cuda.synchronize()
        calls[0] = 0
        t = time.time()
        out = fn()
        torch.cuda.synchronize()
        ms[name] = (time.time() - t) * 1e3
        pbs_batches[name] = calls[0]
        if dec(out) != want:
            wrong.append((name, str(dec(out)), str(want)))
    launches = launched(fp.KERNELS)
    say("main_path_strings", t0, params=p.name, text=text,
        batched_texts=len(words), wall_ms=ms,
        pbs_batches=pbs_batches, wrong=wrong, launches=launches)
    if wrong:
        raise AssertionError(f"string ops wrong: {wrong}")
    # every PBS batch ran in the classic schedule, scan2
    if set(launches) != {"rotate_decompose", "external_product_crt"} or \
            launches["rotate_decompose"] % n:
        raise AssertionError(f"string ops launched {launches}")
    return launches


def strings_card_vs_cpu():
    """The string library at PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST, keys from
    one seed on the card and on the CPU: eq, contains, find, to_uppercase,
    nth_encrypted and push_padding_to_end in the card's compact schedule (a
    random-padded string), the same blocks, degrees and noise levels, word
    for word."""
    import random

    import numpy as np

    from tfhe_tpu_torch import strings

    t0 = time.time()
    outs = {}
    for where in ("cuda", "cpu"):
        cks, sks = strings.gen_keys_test(seed=SEED, device=where)
        h = cks.encrypt_str("hello")
        rp = cks.encrypt_str_random_padding("abc", 2, random.Random(1))
        res = {"eq": sks.eq(h, "hello"), "contains": sks.contains(h, "ll"),
               "find": sks.find(h, "l")[1], "to_uppercase":
               sks.to_uppercase(cks.encrypt_str("aZ")),
               "nth_encrypted": sks.nth_encrypted(
                   h, cks.integer_key.encrypt(1)).ct,
               # the card's schedule, named on the CPU
               "push_padding_to_end": sks._push_padding_compact(rp)}
        got = (cks.integer_key.decrypt_bool(res["eq"]),
               cks.integer_key.decrypt_bool(res["contains"]),
               cks.integer_key.decrypt(res["find"]),
               cks.decrypt_string(res["to_uppercase"]),
               cks.integer_key.decrypt(res["nth_encrypted"]),
               cks.decrypt_string(res["push_padding_to_end"]))
        if got != (True, True, 2, "AZ", ord("e"), "abc"):
            raise AssertionError(f"{where}: string ops wrong: {got}")
        flat = {}
        for k, v in res.items():
            if k in ("to_uppercase", "push_padding_to_end"):
                for i, c in enumerate(v.content):
                    flat[f"{k}[{i}]"] = c.ct.blocks
            else:
                flat[k] = v.blocks if hasattr(v, "blocks") else v.block
        outs[where] = flat
    same = {k: bool(np.array_equal(c.data.cpu().numpy(),
                                   outs["cpu"][k].data.numpy())
                    and np.array_equal(c.degrees, outs["cpu"][k].degrees)
                    and np.array_equal(c.noise, outs["cpu"][k].noise))
            for k, c in outs["cuda"].items()}
    say("card_vs_cpu_strings", t0,
        params="PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST",
        identical=all(same.values()), compared=len(same))
    if not all(same.values()):
        raise AssertionError(f"string ops on the card and the CPU differ: "
                             f"{[k for k, v in same.items() if not v]}")


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
    card, the x // 4 LUT on 64 messages, decrypted right and equal word for
    word to a scan2 key rebuilt from the same raw keys; boolean
    DEFAULT_PARAMETERS mux (two bootstraps in one batch) the same way (one
    LUT and one gate batch keep the smoke inside its watchdog: the identity
    LUT and nand ran here until the parallel, checkpoint and profiling
    phases needed its time; the other gates differ only in their linear
    combinations, which main_path_boolean runs in every mode).  K10
    launches are exact:
    n per PBS batch (one `shoup_mac_primes` launch a step), nothing else
    launches.  Returns K10's launches."""
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
    funcs = (("div4", lambda x: x // 4),)
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

    # the boolean mux
    t2 = time.time()
    bcks, bsks = boolean.gen_keys(bp, seed=SEED, device=dev, mode="ntt")
    torch.cuda.synchronize()
    t_keygen_bool = time.time() - t2
    x, y, z = np.random.default_rng(SEED + 1).integers(
        0, 2, (3, B_MAIN)).astype(bool)
    a, b, c = (bcks.encrypt_batch(v) for v in (x, y, z))
    clear = {"mux": np.where(z, x, y)}
    reset_all_launches()
    t1 = time.time()
    gates = {"mux": bsks.mux_batch(c, a, b)}
    torch.cuda.synchronize()
    t_gates = time.time() - t1
    launches["boolean"] = all_launches()
    for g, o in gates.items():
        correct[f"boolean_{g}"] = int(np.sum(bcks.decrypt_batch(o)
                                             == clear[g]))
    bscan2 = boolean.ServerKey.from_raw(bp, bsks.raw_bsk, bsks.raw_ksk,
                                        device=dev, mode="scan2")
    same["boolean_mux"] = bool(torch.equal(bscan2.mux_batch(c, a, b),
                                           gates["mux"]))
    expected = {"shortint": {"shoup_mac_primes": p.lwe_dimension
                             * len(funcs)},
                "boolean": {"shoup_mac_primes": bp.lwe_dimension}}
    say("main_path_ntt", t0, params=[p.name, bp.name], batch=B_MAIN,
        keygen_s=dict(shortint=t_keygen, boolean=t_keygen_bool),
        lut_s=t_luts, mux_batch_s=t_gates, correct=correct,
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


def u128_lut_check(bsk, lwe, glwe, enc, lwe_std, B, luts=None):
    """The u128 PBS of `luts` (default: U128_LUTS, both) on B encryptions of
    x in [0, 4): returns outputs, the ciphertexts, and the count decrypted
    right."""
    import numpy as np

    from tfhe_tpu_torch import core
    from tfhe_tpu_torch.ops import u128

    k, N = glwe.shape
    delta = (1 << 128) // (2 * U128_MSUP)
    msgs = np.arange(B) % U128_MSUP
    cts = core.encrypt_lwe_u128(lwe, [int(m) * delta for m in msgs], lwe_std,
                                enc)
    outs, correct = {}, {}
    for name, f in (U128_LUTS if luts is None else luts):
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
    one level): keygen on the card, the CRT-NTT layout, the (3x+1) mod 4
    LUT on 64 encryptions, all decrypted right; n K10 launches per
    rotation (the identity LUT, run here until the parallel, checkpoint
    and profiling phases needed the smoke's time, runs in
    card_vs_cpu_ntt).  Returns K10's launches and the keys."""
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
                                   p.lwe_modular_std_dev, B_MAIN,
                                   U128_LUTS[1:])
    torch.cuda.synchronize()
    t_luts = time.time() - t1
    launches = all_launches()
    expected = {"shoup_mac_primes": p.lwe_dimension}
    say("main_path_u128", t0, widths_of=p.name, n=p.lwe_dimension,
        N=p.polynomial_size, k=p.glwe_dimension, base_log=p.pbs_base_log,
        levels=p.pbs_level, batch=B_MAIN, keygen_s=t_keygen,
        lut_and_decrypt_s=t_luts, correct=correct, launches=launches,
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
    """PBS/s and batch ms (host clock, launch cost included, one run) at
    B = 64: shortint mode="ntt", the u128 PBS, boolean gates;
    and a CUDA-event split of one shortint and one u128 step into
    decomposition, forward NTT, K10 (one launch), inverse NTT and CRT.
    The B = 256 rows, a second timed run and the warm-up were cut to keep
    the smoke inside its watchdog: these layouts are off every default
    path."""
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
        # no warm-up: main_path_ntt and main_path_u128 ran these paths at
        # B = 64 just before
        torch.cuda.synchronize()
        t1 = time.time()
        run()
        torch.cuda.synchronize()
        dt = time.time() - t1
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
    for B in (B_MAIN,):
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
    for B in (B_MAIN,):
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
    for B in (B_MAIN,):
        a, b = (bcks.encrypt_batch(rng.integers(0, 2, B).astype(bool))
                for _ in range(2))
        clock(f"boolean_ntt_B{B}", B, lambda: bsks.nand_batch(a, b))  # noqa
    say("timing_ntt", t0, card=card, pbs_or_gates_per_s=rates,
        batch_ms=batch_ms, step_split_ms=split_ms)


API_U64 = (0xDEADBEEFCAFEF00D, 0x0123456789ABCDEF)


def counting_api_key(sks, n):
    """Counters on the API server key `sks`: its host-schedule PBS batches
    (its shortint key's `_pbs_device`, wrapped on the instance) and its
    single-program chains (FusedIntegerOps._replay, wrapped: each call a
    capture at a new (op, shapes), then a replay).  Returns (host, seen,
    chain): host[0] counts host batches, `seen` lists each (key,
    captured) replayed, chain maps each graph's key to the PBS batches of
    its chain (K1's count over its capture, which runs the chain eagerly
    once and counts it once more while capturing, / 2n)."""
    from tfhe_tpu_torch.integer.fused_dispatch import FusedIntegerOps
    from tfhe_tpu_torch.ops import fused_pbs as fp

    isk = sks.integer_key
    key = isk.key
    host, seen, chain = [0], [], {}
    pbs = key._pbs_device

    def counted_pbs(data, acc):
        host[0] += 1
        return pbs(data, acc)

    key._pbs_device = counted_pbs
    if isk._fused_ops is None:
        isk._fused_ops = FusedIntegerOps(isk)
    fops = isk._fused_ops
    replay = fops._replay

    def counted_replay(k, fn, dev):
        new = k not in fops._graphs
        k1 = fp.rotate_decompose.launches
        out = replay(k, fn, dev)
        if new:
            chain[k] = (fp.rotate_decompose.launches - k1) // (2 * n)
        seen.append((k, new))
        return out

    fops._replay = counted_replay
    return host, seen, chain


def api_main_path():
    """The high-level API at full width: generate_keys on the
    ConfigBuilder default (PARAM_MESSAGE_2_CARRY_2_KS_PBS) on the card with
    fused=True, set_server_key, then FheUint64 (32 blocks) +, -, *, a
    scalar +, &, ^, a scalar <<, eq, lt, max, FheBool.if_then_else,
    cast_into(FheUint32) and cast_into(FheInt64); FheInt64 lt and abs;
    FheUint8 div_rem.  Each op runs cold (a single-program chain met first:
    eager warm-up, capture and first replay) and warm once, synchronised;
    its PBS batches, host-schedule and graph-replayed, counted
    (counting_api_key); every result decrypted against the clear Python
    value.  Then + and * again on keys from the same seed with
    fused=False: the same words, and both latencies.  Returns the K1 and
    K2 launches: the counters (each eager launch, and each capture's,
    which launches nothing) less the captures' chains, plus every
    replay's chain (a replay launches with no wrapper call)."""
    import torch

    from tfhe_tpu_torch import api
    from tfhe_tpu_torch.ops import fused_pbs as fp

    t0 = time.time()
    config = api.ConfigBuilder.default().build()
    p = config.parameters
    n = p.lwe_dimension
    cks, sks = api.generate_keys(config, seed=SEED, device="cuda",
                                 fused=True)
    torch.cuda.synchronize()
    t_keygen = time.time() - t0
    api.set_server_key(sks)
    host, seen, chain = counting_api_key(sks, n)
    x, y = API_U64
    m64 = 1 << 64
    a, b = api.FheUint64.encrypt(x, cks), api.FheUint64.encrypt(y, cks)
    cond = api.FheBool.encrypt(True, cks)
    sa, sb_ = api.FheInt64.encrypt(x - m64, cks), api.FheInt64.encrypt(y, cks)
    u8a, u8b = api.FheUint8.encrypt(201, cks), api.FheUint8.encrypt(7, cks)
    ops = {  # name: (the op, the clear result)
        "add": (lambda: a + b, (x + y) % m64),
        "sub": (lambda: a - b, (x - y) % m64),
        "mul": (lambda: a * b, x * y % m64),
        "scalar_add": (lambda: a + 0x9E3779B97F4A7C15,
                       (x + 0x9E3779B97F4A7C15) % m64),
        "bitand": (lambda: a & b, x & y),
        "bitxor": (lambda: a ^ b, x ^ y),
        "scalar_shl": (lambda: a << 13, (x << 13) % m64),
        "eq": (lambda: a.eq(b), x == y),
        "lt": (lambda: a < b, x < y),
        "max": (lambda: a.max(b), max(x, y)),
        "if_then_else": (lambda: cond.if_then_else(a, b), x),
        "cast_u32": (lambda: a.cast_into(api.FheUint32), x % (1 << 32)),
        "cast_i64": (lambda: a.cast_into(api.FheInt64), x - m64),
        "signed_lt": (lambda: sa < sb_, x - m64 < y),
        "signed_abs": (lambda: sa.abs(), m64 - x),
        "u8_div_rem": (lambda: u8a.div_rem(u8b), (201 // 7, 201 % 7)),
    }
    fp.reset_launch_counts()
    cold_ms, warm_ms, batches, wrong, bad_count = {}, {}, {}, [], []
    for name, (fn, want) in ops.items():
        for run in ("cold", "warm"):
            k1, h0, s0 = fp.rotate_decompose.launches, host[0], len(seen)
            torch.cuda.synchronize()
            t = time.time()
            out = fn()
            torch.cuda.synchronize()
            (cold_ms if run == "cold" else warm_ms)[name] = \
                (time.time() - t) * 1e3
            hosted = host[0] - h0
            replayed = sum(chain[k] for k, _ in seen[s0:])
            captured = sum(chain[k] for k, new in seen[s0:] if new)
            # K1 counts each host batch once and each captured chain twice
            if fp.rotate_decompose.launches - k1 != n * (hosted
                                                         + 2 * captured):
                bad_count.append((name, run))
            batches[name] = dict(host=hosted, graph_replayed=replayed)
            got = (tuple(v.decrypt(cks) for v in out)
                   if isinstance(out, tuple) else out.decrypt(cks))
            if got != want:
                wrong.append((name, run, str(got), str(want)))
    # the host schedule, on keys from the same seed
    hc, hs = api.generate_keys(config, seed=SEED, device="cuda", fused=False)
    ha, hb = api.FheUint64.encrypt(x, hc), api.FheUint64.encrypt(y, hc)
    host_ms, host_same = {}, {}
    for name, fn in (("add", lambda: ha + hb), ("mul", lambda: ha * hb)):
        api.set_server_key(hs)
        # one timed run (two until the parallel, checkpoint and profiling
        # phases needed the smoke's time)
        torch.cuda.synchronize()
        t = time.time()
        out = fn()
        torch.cuda.synchronize()
        host_ms[name] = [(time.time() - t) * 1e3]
        api.set_server_key(sks)
        fused_out = ops[name][0]()
        host_same[name] = bool(torch.equal(out.inner.blocks.data,
                                           fused_out.inner.blocks.data))
        if out.decrypt(hc) != ops[name][1]:
            wrong.append((name, "host", str(out.decrypt(hc)),
                          str(ops[name][1])))
    api.set_server_key(None)
    torch.cuda.synchronize()
    counted = launched(fp.KERNELS)
    net = (sum(chain[k] for k, _ in seen)
           - sum(chain[k] for k, new in seen if new))
    launches = {k: counted.get(k, 0) + v * net
                for k, v in rotation_launches("scan2", n).items()}
    say("main_path_api", t0, params=p.name, fheuint64_blocks=32,
        keygen_s=t_keygen, fused=True,
        graphs=sorted({k[0] for k in chain}), cold_ms=cold_ms,
        warm_ms=warm_ms, pbs_batches=batches, host_schedule_ms=host_ms,
        host_equals_fused=host_same, wrong=wrong,
        launch_count_off=bad_count, launches=launches)
    if wrong or not all(host_same.values()) or bad_count:
        raise AssertionError(f"API ops wrong {wrong}, host == fused "
                             f"{host_same}, launch counts off {bad_count}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"API ops launched {launches}")
    return launches


def api_card_vs_cpu():
    """A few API ops at PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST, keys from one
    seed on the card and on the CPU (host schedule): the same words."""
    import numpy as np

    from tfhe_tpu_torch import api
    from tfhe_tpu_torch.params import PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST

    t0 = time.time()
    config = api.ConfigBuilder.default().use_custom_parameters(
        PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST).build()
    outs = {}
    for where in ("cuda", "cpu"):
        cks, sks = api.generate_keys(config, seed=SEED, device=where)
        api.set_server_key(sks)
        a, b = api.FheUint8.encrypt(201, cks), api.FheUint8.encrypt(77, cks)
        res = {"add": a + b, "lt": a < b, "xor_shl": (a ^ b) << 1,
               "cast_i8_abs": a.cast_into(api.FheInt8).abs()}
        got = {k: v.decrypt(cks) for k, v in res.items()}
        if got != {"add": (201 + 77) % 256, "lt": False,
                   "xor_shl": ((201 ^ 77) << 1) % 256, "cast_i8_abs": 55}:
            raise AssertionError(f"{where}: API ops wrong: {got}")
        outs[where] = {k: (v.inner.blocks if hasattr(v.inner, "blocks")
                           else v.inner.block) for k, v in res.items()}
    api.set_server_key(None)
    same = {k: bool(np.array_equal(c.data.cpu().numpy(),
                                   outs["cpu"][k].data.numpy())
                    and np.array_equal(c.degrees, outs["cpu"][k].degrees))
            for k, c in outs["cuda"].items()}
    say("card_vs_cpu_api", t0, params=PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST.name,
        identical=all(same.values()), compared=sorted(same))
    if not all(same.values()):
        raise AssertionError(f"API ops on the card and the CPU differ: "
                             f"{same}")


def multibit_ntt_main_path(cks, sks):
    """The multi-bit CRT-NTT key layout (mode="ntt") at GROUP_3 on the card:
    the raw keys of main_path_multibit through ServerKey.from_raw(...,
    mode="ntt"); one LUT batch at B = 64 (cold, then timed), word for word
    equal to the scan3 key's; the prepare s, PBS/s and peak device MB.
    The step is torch ops (the reference's is jnp ops): no wrapper of ours
    launches."""
    import numpy as np
    import torch

    from tfhe_tpu_torch import core, shortint

    t0 = time.time()
    mp = sks.params
    torch.cuda.reset_peak_memory_stats()
    t = time.time()
    nsks = shortint.ServerKey.from_raw(mp, sks.raw_bsk, sks.raw_ksk,
                                       device="cuda", mode="ntt")
    torch.cuda.synchronize()
    t_prepare = time.time() - t
    if not isinstance(nsks.bsk, core.PreparedMultiBitBskNtt):
        raise AssertionError("mode 'ntt' did not prepare the CRT-NTT layout")
    f = lambda v: (3 * v + 1) % 16  # noqa: E731
    lut = sks.generate_lookup_table(f)
    msgs = np.arange(B_MAIN) % mp.total_modulus
    data = cks.encrypt_batch(msgs).data
    want = sks._pbs_device(data, lut.acc)  # scan3, on the kernels
    torch.cuda.synchronize()
    reset_all_launches()
    t = time.time()
    got = nsks._pbs_device(data, lut.acc)
    torch.cuda.synchronize()
    cold_s = time.time() - t
    t = time.time()
    again = nsks._pbs_device(data, lut.acc)
    torch.cuda.synchronize()
    warm_s = time.time() - t
    launches = all_launches()
    same = bool(torch.equal(got, want) and torch.equal(again, want))
    correct = int(np.sum(cks.decrypt_batch_message_and_carry(got)
                         == f(msgs)))
    say("main_path_multibit_ntt", t0, params=mp.name, batch=B_MAIN,
        group_steps=mp.lwe_dimension // mp.grouping_factor,
        prepare_s=t_prepare, cold_batch_s=cold_s, warm_batch_s=warm_s,
        pbs_per_s=B_MAIN / warm_s, equals_scan3=same, correct=correct,
        key_mb=nsks.bsk.spectra.numel() * 4 / 2**20,
        peak_device_mb=torch.cuda.max_memory_allocated() / 2**20,
        launches=launches)
    if not same or correct != B_MAIN:
        raise AssertionError(f"multi-bit mode 'ntt': equal to scan3 {same}, "
                             f"{correct} of {B_MAIN} decrypted right")
    if launches:
        raise AssertionError(f"the CRT-NTT multi-bit step launched "
                             f"{launches}")


SHA_MASK = 0xFFFFFFFF
# compression rounds of the SHA-256 part: 2 (4 until the parallel, checkpoint
# and profiling phases needed the smoke's time)
SHA_ROUNDS = 2


def sha256_clear(state, words, rounds):
    """The clear SHA-256 compression cut to `rounds` rounds (the schedule
    words past 16 expanded as FIPS 180-4 does), to check the encrypted
    circuit."""
    from tfhe_tpu_torch.examples.sha256_bool import K

    def rotr(x, n):
        return ((x >> n) | (x << (32 - n))) & SHA_MASK

    w = list(words)
    for t in range(16, rounds):
        s0 = rotr(w[t - 15], 7) ^ rotr(w[t - 15], 18) ^ (w[t - 15] >> 3)
        s1 = rotr(w[t - 2], 17) ^ rotr(w[t - 2], 19) ^ (w[t - 2] >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & SHA_MASK)
    a, b, c, d, e, f, g, h = state
    for t in range(rounds):
        s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = (h + s1 + ch + K[t] + w[t]) & SHA_MASK
        s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = (s0 + maj) & SHA_MASK
        h, g, f = g, f, e
        e = (d + t1) & SHA_MASK
        d, c, b = c, b, a
        a = (t1 + t2) & SHA_MASK
    return [(x + y) & SHA_MASK
            for x, y in zip(state, [a, b, c, d, e, f, g, h])], w


def bits_hex(bits):
    bits = [int(v) for v in bits]
    return "".join(f"{sum(v << j for j, v in enumerate(bits[i:i + 8])):02X}"
                   for i in range(0, len(bits), 8))


def examples_radix_part(cks, sks):
    """The dark market (one order book at 8 blocks) and three regex
    patterns (texts of at most 6 chars) on the main path's
    PARAM_MESSAGE_2_CARRY_2_KS_PBS keys, each decrypted against its clear
    function; per part the wall s and PBS batches (K1 launches / n).
    Returns (fields, launches)."""
    import torch

    from tfhe_tpu_torch import integer, strings
    from tfhe_tpu_torch.examples import dark_market, regex_engine
    from tfhe_tpu_torch.ops import fused_pbs as fp

    n = sks.params.lwe_dimension
    fp.reset_launch_counts()
    fields, wrong = {}, []
    t = time.time()
    rck = integer.RadixClientKey(sks.params, 8, _key=cks)
    isk = integer.IntegerServerKey(sks)
    sells, buys = [1200, 800, 350], [1000, 900]
    got = dark_market.run_example(rck, isk, sells, buys)
    torch.cuda.synchronize()
    if got != dark_market.volume_match_plain(sells, buys):
        wrong.append(("dark_market", str(got)))
    fields["dark_market"] = dict(
        num_blocks=8, sells=sells, buys=buys, s=time.time() - t,
        pbs_batches=fp.rotate_decompose.launches // n)
    scks = strings.StringClientKey(
        integer.RadixClientKey(sks.params, strings.NUMBER_BLOCKS, _key=cks))
    ssks = strings.StringServerKey(isk)
    regex = {}
    for text, pattern, want in (("hello", "/^h[a-e]llo$/", True),
                                ("heo", "/hel*o/", True),
                                ("HELLO", "/hello/i", True)):
        k1 = fp.rotate_decompose.launches
        t = time.time()
        out = regex_engine.has_match(ssks, scks.encrypt_str(text), pattern)
        got = scks.integer_key.decrypt_bool(out)
        regex[f"{text} {pattern}"] = dict(
            s=time.time() - t,
            pbs_batches=(fp.rotate_decompose.launches - k1) // n)
        if got is not want:
            wrong.append((pattern, text, got))
    fields["regex"] = regex
    if wrong:
        raise AssertionError(f"examples wrong: {wrong}")
    return fields, launched(fp.KERNELS)


def examples_boolean_part(cks, sks):
    """SHA-256 (a 2-round compression and one schedule expansion) and
    Trivium (the full 1152-step warm-up, the first 64 keystream bits for
    key = iv = 0 against the KAT FBE0BF265859051B, then one transciphered
    word) on the boolean DEFAULT_PARAMETERS keys of main_path_boolean;
    per part the wall s and gate batches (K1 launches / n).  Returns
    (fields, launches)."""
    import numpy as np
    import torch

    from tfhe_tpu_torch.apps import trivium
    from tfhe_tpu_torch.examples import sha256_bool as sb
    from tfhe_tpu_torch.ops import fused_pbs as fp

    n = sks.params.lwe_dimension
    fp.reset_launch_counts()
    fields, wrong = {}, []
    rng = np.random.default_rng(SEED + 17)
    words = [int(v) for v in rng.integers(0, 1 << 32, 16)]
    t = time.time()
    eng = sb.Sha256Fhe(sks)
    enc = sb.encrypt_words(cks, words)
    out = eng.compress([eng.trivial_word(h) for h in sb.H_INIT], enc,
                       rounds=SHA_ROUNDS)
    got = [sb.decrypt_word(cks, w) for w in out]
    want, _ = sha256_clear(sb.H_INIT, words, SHA_ROUNDS)
    if got != want:
        wrong.append((f"sha256_{SHA_ROUNDS}_rounds", got, want))
    fields[f"sha256_{SHA_ROUNDS}_rounds"] = dict(
        s=time.time() - t, gate_batches=eng._gates,
        pbs_batches=fp.rotate_decompose.launches // n)
    k1, g0 = fp.rotate_decompose.launches, eng._gates
    t = time.time()
    w16 = eng.add_many([eng._small_sigma1(enc[14]), enc[9],
                        eng._small_sigma0(enc[1]), enc[0]])
    got16 = sb.decrypt_word(cks, w16)
    _, w = sha256_clear(sb.H_INIT, words, 17)
    if got16 != w[16]:
        wrong.append(("sha256_schedule", got16, w[16]))
    fields["sha256_schedule_word"] = dict(
        s=time.time() - t, gate_batches=eng._gates - g0,
        pbs_batches=(fp.rotate_decompose.launches - k1) // n)
    k1 = fp.rotate_decompose.launches
    t = time.time()
    stream = trivium.trivium_fhe(cks, sks, [0] * 80, [0] * 80)
    z = stream.next_64()
    torch.cuda.synchronize()
    t_kat = time.time() - t
    kat = bits_hex(cks.decrypt_batch(z))
    if kat != "FBE0BF265859051B":
        wrong.append(("trivium_kat", kat))
    clear = trivium.trivium_clear([0] * 80, [0] * 80)
    clear.next_64()
    ks2 = clear.next_64()
    data = int(rng.integers(0, 1 << 63))
    masked = [((data >> i) & 1) ^ int(k) for i, k in enumerate(ks2)]
    t = time.time()
    plain = cks.decrypt_batch(trivium.trans_decrypt_64(sks, stream, masked))
    t_trans = time.time() - t
    if sum(int(v) << i for i, v in enumerate(plain)) != data:
        wrong.append(("transciphering", data))
    fields["trivium"] = dict(
        warmup_steps=64 * trivium.TriviumStream.WARMUP_WAVES,
        warmup_and_first_word_s=t_kat, first_64_bits=kat,
        transciphered_word_s=t_trans,
        pbs_batches=(fp.rotate_decompose.launches - k1) // n)
    if wrong:
        raise AssertionError(f"examples wrong: {wrong}")
    return fields, launched(fp.KERNELS)


def examples_cli():
    """`python -m tfhe_tpu_torch.examples.fhe_strings_cli aba a
    --real-params` as a subprocess on the card: it exits 0, every op's line
    (14 ops) says ok and none MISMATCH (on "abcab ab" until the parallel,
    checkpoint and profiling phases needed the smoke's time)."""
    import os

    t = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "tfhe_tpu_torch.examples.fhe_strings_cli",
         "aba", "a", "--real-params"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=300)
    lines = [ln.split() for ln in proc.stdout.splitlines()
             if ln.rstrip().endswith(" ok")]
    fields = dict(rc=proc.returncode, s=time.time() - t,
                  ops_ok=len(lines),
                  op_ms={ln[0]: float(ln[1]) for ln in lines})
    if (proc.returncode != 0 or "MISMATCH" in proc.stdout
            or len(lines) != 14):
        raise AssertionError(f"fhe_strings_cli: rc {proc.returncode}, "
                             f"stdout {proc.stdout[-2000:]}, stderr "
                             f"{proc.stderr[-2000:]}")
    return fields



# ---------------------------------------------------------------------------
# WoPBS, the wide core variant, and the public, seeded and compressed keys
# ---------------------------------------------------------------------------


class WopbsCounts:
    """Counts the PBS batches and CMuxes of `core.wopbs` while active (the
    module's own calls go through these names)."""

    def __init__(self):
        from tfhe_tpu_torch.core import wopbs as wop

        self.wop, self.pbs, self.cmux = wop, 0, 0
        self._saved = (wop.programmable_bootstrap, wop.cmux_dynamic)

    def __enter__(self):
        pbs, cmux = self._saved

        def counted_pbs(*args):
            self.pbs += 1
            return pbs(*args)

        def counted_cmux(*args):
            self.cmux += 1
            return cmux(*args)

        self.wop.programmable_bootstrap = counted_pbs
        self.wop.cmux_dynamic = counted_cmux
        return self

    def __exit__(self, *exc):
        self.wop.programmable_bootstrap, self.wop.cmux_dynamic = self._saved


def wopbs_stages(wk, batch, lut):
    """wopbs_batch's three stages, each synchronised and timed: -> (output
    data, {stage: ms}, PBS batches, CMuxes)."""
    import torch

    from tfhe_tpu_torch.core import wopbs as wop

    p = wk.params
    delta_log = p.delta.bit_length() - 1
    ms = {}
    with WopbsCounts() as counts:
        t = time.time()
        bits = wk.extract_bits_batch(batch, delta_log, wk._nb_bits)
        torch.cuda.synchronize()
        ms["extract_bits"] = (time.time() - t) * 1e3
        t = time.time()
        ggsw = [wk.cbs.circuit_bootstrap(bits[:, j], 63)
                for j in range(wk._nb_bits)]
        torch.cuda.synchronize()
        ms["circuit_bootstrap"] = (time.time() - t) * 1e3
        t = time.time()
        out = wop.vertical_packing(lut.polys, ggsw, p.glwe_size,
                                   p.cbs_base_log, p.cbs_level)
        torch.cuda.synchronize()
        ms["vertical_packing"] = (time.time() - t) * 1e3
    return out, ms, counts.pbs, counts.cmux


def key_mb(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors) / 1e6


def wopbs_main_path():
    """WOPBS_PARAM_MESSAGE_2_CARRY_2_KS_PBS on the card: keygen (with the
    pfpksk list), wopbs_batch on the 16 packed values with an identity, a
    message and a full-domain LUT, and IntegerWopbsKey.wopbs on a 4-block
    radix; every output decrypted; the stages' ms, PBS batches, CMuxes and
    K1 / K2 launches.  Returns the launches."""
    import numpy as np
    import torch

    from tfhe_tpu_torch import integer, shortint
    from tfhe_tpu_torch.params import WOPBS_PARAM_MESSAGE_2_CARRY_2_KS_PBS

    p = WOPBS_PARAM_MESSAGE_2_CARRY_2_KS_PBS
    t0 = time.time()
    reset_all_launches()
    cks, sks, wk = shortint.gen_keys_wopbs(p, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    keygen_s = time.time() - t0
    mb = dict(bsk_ksk=key_mb(sks.raw_bsk, sks.raw_ksk),
              pfpksk=key_mb(wk.cbs.pfpksk_list))
    msgs = np.arange(p.total_modulus)
    batch = cks.encrypt_batch(msgs)
    cases = {"identity": (wk.generate_lut(lambda x: x), cks.decrypt_batch,
                          msgs % p.message_modulus),
             "message": (wk.generate_lut(lambda x: (3 * x + 1) % 4),
                         cks.decrypt_batch, (3 * msgs + 1) % 4),
             "full_domain": (wk.generate_lut_full_domain(
                 lambda x: (x * x + 5) % 16),
                 cks.decrypt_batch_message_and_carry, (msgs * msgs + 5) % 16)}
    correct, stages = {}, {}
    for name, (lut, dec, want) in cases.items():
        out, ms, pbs, cmux = wopbs_stages(wk, batch, lut)
        correct[name] = int(np.sum(dec(out) == want))
        stages[name] = dict(ms=ms, pbs_batches=pbs, cmuxes=cmux)
    # the integer WoPBS: (x * 3 + 5) mod 256 on a 4-block radix (8 bits)
    rck = integer.RadixClientKey(p, 4, _key=cks)
    iwk = integer.IntegerWopbsKey(wk)
    values = (0, 11, 200, 255)
    t1 = time.time()
    with WopbsCounts() as counts:
        int_ok = 0
        for v in values:
            ct = rck.encrypt(v)
            out = iwk.wopbs(ct, iwk.generate_lut(ct, lambda x: (x * 3 + 5)
                                                 % 256))
            int_ok += rck.decrypt(out) == (v * 3 + 5) % 256
    torch.cuda.synchronize()
    launches = all_launches()
    say("main_path_wopbs", t0, params=p.name, keygen_s=keygen_s, key_mb=mb,
        batch=int(len(msgs)), correct=correct, stages=stages,
        integer=dict(blocks=4, values=list(values), correct=int(int_ok),
                     ms_each=(time.time() - t1) * 1e3 / len(values),
                     pbs_batches=counts.pbs, cmuxes=counts.cmux),
        launches=launches)
    if (any(v != len(msgs) for v in correct.values())
            or int_ok != len(values)):
        raise AssertionError(f"WoPBS: {correct} of {len(msgs)}, integer "
                             f"{int_ok} of {len(values)}")
    if min(launches.get(k, 0) for k in ("rotate_decompose",
                                        "external_product_crt")) <= 0:
        raise AssertionError(f"the WoPBS launched {launches}")
    return launches


def kernels_wide_phase(dev):
    """The core's widest variants and main_path_wopbs's own shape: one LUT
    batch (B = 8) at PARAM_4_BITS_5_BLOCKS (L*G = 18), at
    WOPBS_PARAM_MESSAGE_1_NORM2_6_KS_PBS (L*G = 12) and at
    WOPBS_PARAM_MESSAGE_2_CARRY_2_KS_PBS (L*G = 4, N = 2048, base_log 15),
    decrypted, and identical in all six classic schedules; K1 and every
    classic kernel on the core (K2, ntt_mac_prime, K3, K4, and K5 and K7
    over 4 steps) at the three widths against their plain versions on
    the card (tolerance 0), K2's device ms and bound at 18 digits, and a
    WoPBS at PARAM_4_BITS_5_BLOCKS decrypted.  Returns (errors, K2 times and
    bound at 18 digits, launches)."""
    import numpy as np
    import torch

    from tfhe_tpu_torch import shortint
    from tfhe_tpu_torch.ops import fused_pbs as fp
    from tfhe_tpu_torch.core import keyswitch_then_pbs
    from tfhe_tpu_torch.params import (WOPBS_PARAM_MESSAGE_2_CARRY_2_KS_PBS,
                                       wopbs_params)

    t0 = time.time()
    rng = np.random.default_rng([SEED, 18])
    B, P, steps = 8, 5, 4
    errs, wide, lut_ok, modes_same = {}, {}, {}, {}
    launches = {}
    for p in (wopbs_params.PARAM_4_BITS_5_BLOCKS,
              wopbs_params.WOPBS_PARAM_MESSAGE_1_NORM2_6_KS_PBS,
              WOPBS_PARAM_MESSAGE_2_CARRY_2_KS_PBS):
        N, G, L, bl = (p.polynomial_size, p.glwe_size, p.pbs_level,
                       p.pbs_base_log)
        LJ = L * G
        reset_all_launches()
        if LJ == 18:
            cks, sks, wk = shortint.gen_keys_wopbs(p, seed=SEED, device=dev)
        else:
            cks, sks = shortint.gen_keys(p, seed=SEED, device=dev)
        msgs = np.arange(B) % p.total_modulus
        f = (lambda x, t=p.total_modulus: (x + 1) % t)
        out = sks.apply_lookup_table_batch(cks.encrypt_batch(msgs),
                                           sks.generate_lookup_table(f))
        lut_ok[p.name] = int(np.sum(cks.decrypt_batch_message_and_carry(out)
                                    == (msgs + 1) % p.total_modulus))
        for k, v in all_launches().items():
            launches[k] = launches.get(k, 0) + v
        reset_all_launches()

        def words(*shape):
            return torch.from_numpy(rng.integers(
                0, 2**64 - 1, shape, dtype=np.uint64, endpoint=True)
                .view(np.int64)).to(dev)

        # the LUT batch in every classic schedule: the same words
        data = cks.encrypt_batch(msgs).data
        acc_lut = sks.generate_lookup_table(f).acc
        want = keyswitch_then_pbs(sks.ksk, sks.bsk, acc_lut, data, "scan2")
        modes_same[p.name] = {
            m: bool(torch.equal(keyswitch_then_pbs(sks.ksk, sks.bsk, acc_lut,
                                                   data, m), want))
            for m in fp.MODES[1:]}
        reset_all_launches()
        acc = words(B, G, N)
        ahat = torch.from_numpy(rng.integers(0, 2 * N, (steps, B),
                                             endpoint=True)
                                .astype(np.int32)).to(dev)
        kspec, kshoup = sks.bsk.kspec[:steps], sks.bsk.kshoup[:steps]
        ks, ksh = kspec[0], kshoup[0]
        dig = fp.rotate_decompose_plain(acc, ahat[0], bl, L)
        res_shape = (B, G, 2, P, N)
        res_p = torch.empty(res_shape, dtype=torch.int32, device=dev)
        res_k = torch.empty(res_shape, dtype=torch.int32, device=dev)
        for pi in range(P):
            fp.ntt_mac_prime_plain(dig, ks[pi], pi, res_p)
            fp.ntt_mac_prime(dig, ks[pi], ksh[pi], pi, res_k)
        step_plain = fp.pbs_step_plain(acc, ahat[0], ks, bl, L)
        whole_plain = fp.blind_rotate_persistent_plain(acc, ahat, kspec, bl,
                                                       L)
        errs[p.name] = dict(
            rotate_decompose=max_abs_err(
                fp.rotate_decompose(acc, ahat[0], bl, L), dig),
            external_product_crt=max_abs_err(
                fp.external_product_crt(dig, ks, ksh, acc),
                fp.external_product_crt_plain(dig, ks, acc)),
            ntt_mac_prime=max_abs_err(res_k, res_p),
            pbs_step=max_abs_err(
                fp.pbs_step(acc, ahat[0], ks, ksh, bl, L), step_plain),
            pbs_step_single_cta=max_abs_err(
                fp.pbs_step_single_cta(acc, ahat[0], ks, ksh, bl, L),
                step_plain),
            blind_rotate_persistent=max_abs_err(
                fp.blind_rotate_persistent(acc, ahat, kspec, kshoup, bl, L),
                whole_plain),
            blind_rotate_single_cta=max_abs_err(
                fp.blind_rotate_single_cta(acc, ahat, kspec, kshoup, bl, L),
                whole_plain))
        if LJ == 18:
            acc64 = words(B_MAIN, G, N)
            ahat64 = torch.from_numpy(rng.integers(0, 2 * N, (B_MAIN,),
                                                   endpoint=True)
                                      .astype(np.int32)).to(dev)
            dig64 = fp.rotate_decompose(acc64, ahat64, bl, L)
            ks, ksh = sks.bsk.kspec[0], sks.bsk.kshoup[0]
            bound = bounds_ms(B_MAIN, G, L, N, P)["external_product_crt"]
            wide = dict(
                params=p.name, digit_polys=LJ, batch=B_MAIN,
                ms=graph_ms(lambda: fp.external_product_crt(
                    dig64, ks, ksh, acc64), 50),
                plain_ms=cuda_ms(lambda: fp.external_product_crt_plain(
                    dig64, ks, acc64), 2, warmup=1),
                bound_ms=bound[0], bound_by=bound[1])
            # a WoPBS at this set, on every value of its 16
            wmsgs = np.arange(p.total_modulus)
            wlut = wk.generate_lut(lambda x: (5 * x + 3) % 16)
            reset_all_launches()
            t1 = time.time()
            wout, ms, pbs, cmux = wopbs_stages(wk, cks.encrypt_batch(wmsgs),
                                               wlut)
            wide["wopbs"] = dict(
                values=int(len(wmsgs)), ms=ms, pbs_batches=pbs, cmuxes=cmux,
                wall_s=time.time() - t1, correct=int(np.sum(
                    cks.decrypt_batch(wout) == (5 * wmsgs + 3) % 16)))
            for k, v in all_launches().items():
                launches[k] = launches.get(k, 0) + v
            del wk
        del cks, sks
        torch.cuda.empty_cache()
    say("kernels_wide", t0, max_abs_err=errs, lut_batch_correct=lut_ok,
        modes_identical_to_scan2=modes_same, k2_18_digits=wide,
        launches=launches)
    bad = [e for v in errs.values() for e in v.values() if e]
    if bad or any(v != B for v in lut_ok.values()) or \
            not all(x for v in modes_same.values() for x in v.values()) or \
            wide["wopbs"]["correct"] != wide["wopbs"]["values"]:
        raise AssertionError(f"wide core: errors {errs}, LUT batches "
                             f"{lut_ok}, modes {modes_same}, WoPBS "
                             f"{wide['wopbs']}")
    return errs, wide, launches


def wopbs_card_vs_cpu():
    """A WoPBS at WOPBS_PARAM_MESSAGE_2_CARRY_2_TEST on the card and on the
    CPU from one seed: identical words."""
    import numpy as np
    import torch

    from tfhe_tpu_torch import shortint
    from tfhe_tpu_torch.params import WOPBS_PARAM_MESSAGE_2_CARRY_2_TEST

    t0 = time.time()
    outs = {}
    for where in ("cuda", "cpu"):
        cks, _, wk = shortint.gen_keys_wopbs(WOPBS_PARAM_MESSAGE_2_CARRY_2_TEST,
                                             seed=SEED, device=where)
        msgs = np.arange(16)
        out = wk.wopbs_batch(cks.encrypt_batch(msgs),
                             wk.generate_lut_full_domain(lambda x: (7 * x)
                                                         % 16))
        if not np.array_equal(cks.decrypt_batch_message_and_carry(out),
                              (7 * msgs) % 16):
            raise AssertionError(f"{where}: WoPBS at the test set wrong")
        outs[where] = out.data.cpu()
    same = bool(torch.equal(outs["cuda"], outs["cpu"]))
    say("card_vs_cpu_wopbs", t0, params=WOPBS_PARAM_MESSAGE_2_CARRY_2_TEST
        .name, identical=same)
    if not same:
        raise AssertionError("card and CPU WoPBS words differ")


def keys_main_path(cks, sks):
    """The public, compact and compressed keys and the wire format at
    PARAM_MESSAGE_2_CARRY_2_KS_PBS (the compact key at
    PARAM_MESSAGE_2_CARRY_2_COMPACT_PK_KS_PBS), on the main path's keys.
    Returns the launches."""
    import numpy as np
    import torch

    from tfhe_tpu_torch import api, integer, shortint
    from tfhe_tpu_torch.core import seeded
    from tfhe_tpu_torch.params import (
        PARAM_MESSAGE_2_CARRY_2_COMPACT_PK_KS_PBS)
    from tfhe_tpu_torch.utils.serialization import (safe_deserialize,
                                                    safe_serialize, serialize)

    t0 = time.time()
    reset_all_launches()
    p = cks.params
    msgs = np.arange(B_MAIN) % p.total_modulus
    fields, bad = {}, []

    def sync_s(t):
        torch.cuda.synchronize()
        return time.time() - t

    # the standard public key (2049 * 64 + 128 zero encryptions), made
    # through the API; its shortint key is .inner
    hl_cks = api.ClientKey(api.Config(parameters=p),
                           _radix=integer.RadixClientKey(p, 1, _key=cks))
    t = time.time()
    hl_pk = api.PublicKey(hl_cks)
    pk_keygen_s = sync_s(t)
    pk = hl_pk.inner
    t = time.time()
    batch = pk.encrypt_batch(msgs, seed=SEED)
    enc_ms = sync_s(t) * 1e3
    t = time.time()
    pk.encrypt_batch(msgs, seed=SEED + 1)
    enc_warm_ms = sync_s(t) * 1e3
    lut = sks.generate_lookup_table(lambda x: (x + 3) % 16)
    out = sks.apply_lookup_table_batch(batch, lut)
    fields["public_key"] = dict(
        keygen_s=pk_keygen_s, mb=key_mb(pk.key.zero_encs),
        zero_encryptions=pk.key.zero_encryption_count, batch=B_MAIN,
        encrypt_ms=enc_ms, encrypt_warm_ms=enc_warm_ms,
        correct=int(np.sum(cks.decrypt_batch_message_and_carry(batch)
                           == msgs)),
        lut_correct=int(np.sum(cks.decrypt_batch_message_and_carry(out)
                               == (msgs + 3) % 16)))
    # the API: a FheUint8 under the same public key
    fields["api_public_key"] = int(api.FheUint8.encrypt_with_public_key(
        201, hl_pk).decrypt(hl_cks) == 201)
    del pk, hl_pk, batch
    torch.cuda.empty_cache()

    # the compact public key, and a compact FheUint64 through the API
    cp = PARAM_MESSAGE_2_CARRY_2_COMPACT_PK_KS_PBS
    c_cks = shortint.ClientKey(cp, seed=SEED, device="cuda")
    hl_ccks = api.ClientKey(api.Config(parameters=cp),
                            _radix=integer.RadixClientKey(cp, 1, _key=c_cks))
    t = time.time()
    hl_cpk = api.CompactPublicKey(hl_ccks)
    cpk_keygen_ms = sync_s(t) * 1e3
    cpk = hl_cpk.inner
    t = time.time()
    compact = cpk.encrypt_compact_batch(msgs, seed=SEED)
    c_enc_ms = sync_s(t) * 1e3
    t = time.time()
    expanded = compact.expand()
    expand_ms = sync_s(t) * 1e3
    v64 = 2**64 - 12345
    fields["compact_public_key"] = dict(
        params=cp.name, keygen_ms=cpk_keygen_ms, batch=B_MAIN,
        encrypt_ms=c_enc_ms, expand_ms=expand_ms,
        bytes_compact=len(serialize(compact)),
        bytes_expanded=len(serialize(expanded)),
        correct=int(np.sum(c_cks.decrypt_batch_message_and_carry(expanded)
                           == msgs)),
        api_fheuint64=int(api.CompactFheUint64.encrypt(v64, hl_cpk).expand()
                          .decrypt(hl_ccks) == v64))
    del c_cks, cpk, compact, expanded, hl_cpk, hl_ccks

    # the compressed server key: bytes, decompression, a LUT batch, and the
    # CPU's decompression of the same bytes
    t = time.time()
    comp = shortint.CompressedServerKey(cks)
    comp_keygen_s = sync_s(t)
    comp_bytes = serialize(comp)
    t = time.time()
    dsks = comp.decompress()
    decompress_s = sync_s(t)
    data = cks.encrypt_batch(msgs)
    out = dsks.apply_lookup_table_batch(data, dsks.generate_lookup_table(
        lambda x: (5 * x) % 16))
    cpu_comp = safe_deserialize(comp_bytes, device="cpu")
    same_raw = (torch.equal(seeded.decompress_bootstrap_key(
        cpu_comp.seeded_bsk), dsks.raw_bsk.cpu())
        and torch.equal(seeded.decompress_keyswitch_key(cpu_comp.seeded_ksk),
                        dsks.raw_ksk.cpu()))
    # the server key through the wire format, each way
    t = time.time()
    sks_bytes = safe_serialize(sks)
    ser_s = time.time() - t
    t = time.time()
    back = safe_deserialize(sks_bytes, expected_params=p)
    de_s = sync_s(t)
    lut = sks.generate_lookup_table(lambda x: (x * x) % 16)
    same_words = torch.equal(back.apply_lookup_table_batch(data, lut).data,
                             sks.apply_lookup_table_batch(data, lut).data)
    fields["compressed_server_key"] = dict(
        keygen_s=comp_keygen_s, bytes=len(comp_bytes),
        server_key_bytes=len(sks_bytes), decompress_s=decompress_s,
        lut_correct=int(np.sum(cks.decrypt_batch_message_and_carry(out)
                               == (5 * msgs) % 16)),
        cpu_decompression_identical=bool(same_raw))
    fields["server_key_wire"] = dict(
        bytes=len(sks_bytes), serialize_s=ser_s, deserialize_s=de_s,
        lut_batch_identical=bool(same_words))
    del comp, dsks, back, cpu_comp, sks_bytes, comp_bytes
    torch.cuda.empty_cache()
    launches = all_launches()
    say("main_path_keys", t0, params=p.name, **fields, launches=launches)
    checks = (fields["public_key"]["correct"] == B_MAIN,
              fields["public_key"]["lut_correct"] == B_MAIN,
              fields["api_public_key"] == 1,
              fields["compact_public_key"]["correct"] == B_MAIN,
              fields["compact_public_key"]["api_fheuint64"] == 1,
              fields["compressed_server_key"]["lut_correct"] == B_MAIN,
              same_raw, same_words)
    if not all(checks):
        raise AssertionError(f"keys phase failed: {checks}")
    return launches


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
    int_launches, host_ms, host_batches = integer_main_path(cks, sks)
    for k, v in int_launches.items():
        launches[k] = launches.get(k, 0) + v
    t_integer = time.time() - t1
    integer_card_vs_cpu()
    t1 = time.time()
    for k, v in integer_fused_main_path(cks, sks, host_ms,
                                        host_batches).items():
        launches[k] = launches.get(k, 0) + v
    t_fused = time.time() - t1
    # the checkout's scratch for the new phases' files (trace, checkpoints,
    # the two-rank store), removed at the end
    scratch = tempfile.TemporaryDirectory(
        prefix="smoke_", dir=os.path.dirname(os.path.abspath(__file__)))
    t1 = time.time()
    for k, v in parallel_main_path(cks, sks, scratch.name).items():
        launches[k] = launches.get(k, 0) + v
    t_parallel = time.time() - t1
    t1 = time.time()
    for k, v in checkpoint_main_path(cks, sks, scratch.name).items():
        launches[k] = launches.get(k, 0) + v
    t_checkpoint = time.time() - t1
    t1 = time.time()
    for k, v in profiling_main_path(cks, sks, scratch.name).items():
        launches[k] = launches.get(k, 0) + v
    t_profiling = time.time() - t1
    scratch.cleanup()
    t1 = time.time()
    for k, v in batched_main_path(cks, sks).items():
        launches[k] = launches.get(k, 0) + v
    t_batched = time.time() - t1
    t1 = time.time()
    for k, v in strings_main_path(cks, sks).items():
        launches[k] = launches.get(k, 0) + v
    t_strings = time.time() - t1
    strings_card_vs_cpu()
    t1 = time.time()
    examples, examples_launches_radix = examples_radix_part(cks, sks)
    t_examples = time.time() - t1
    for k, v in examples_launches_radix.items():
        launches[k] = launches.get(k, 0) + v
    t1 = time.time()
    for k, v in api_main_path().items():
        launches[k] = launches.get(k, 0) + v
    t_api = time.time() - t1
    api_card_vs_cpu()
    t1 = time.time()
    pk_launches, pk_cks, pk_sks = pbs_ks_main_path(dev)
    t_pbs_ks = time.time() - t1
    for k, v in pk_launches.items():
        launches[k] = launches.get(k, 0) + v
    t1 = time.time()
    for k, v in keys_main_path(cks, sks).items():
        launches[k] = launches.get(k, 0) + v
    t_keys = time.time() - t1

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

    # -- WoPBS at full width, the core's 18-digit variant --------------------
    t0 = time.time()
    for k, v in wopbs_main_path().items():
        launches[k] = launches.get(k, 0) + v
    t_wopbs = time.time() - t0
    wide_errs, wide_k2, wide_launches = kernels_wide_phase(dev)
    for k, v in wide_launches.items():
        launches[k] = launches.get(k, 0) + v
    wopbs_card_vs_cpu()
    torch.cuda.empty_cache()

    # -- 6-9. the multi-bit path -------------------------------------------
    t0 = time.time()
    mb_launches, mb_cks, mb_sks = multibit_main_path(dev)
    t_main_mb = time.time() - t0
    multibit_card_vs_cpu(dev)
    multibit_timing(card, dev, mb_cks, mb_sks, rng)
    t0 = time.time()
    multibit_ntt_main_path(mb_cks, mb_sks)
    t_main_mb_ntt = time.time() - t0
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
    t0 = time.time()
    fields, bool_ex_launches = examples_boolean_part(bool_cks, bool_sks)
    examples.update(fields)
    for k, v in bool_ex_launches.items():
        launches[k] = launches.get(k, 0) + v
    del bool_cks, bool_sks
    torch.cuda.empty_cache()
    examples["fhe_strings_cli"] = examples_cli()
    t_examples += time.time() - t0
    ex_launches = {k: bool_ex_launches.get(k, 0)
                   + examples_launches_radix.get(k, 0)
                   for k in set(bool_ex_launches) | set(
                       examples_launches_radix)}
    say("main_path_examples", t0, card=card, all_parts_s=t_examples,
        parts=examples, launches=ex_launches)
    if min(ex_launches.get(k, 0) for k in ("rotate_decompose",
                                           "external_product_crt")) <= 0:
        raise AssertionError(f"the examples launched {ex_launches}")

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
    for k in errs:  # kernels_wide's three widths' errors too, where checked
        errs[k] = max([errs[k]] + [e[k] for e in wide_errs.values()
                                   if k in e])
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
        if name == "external_product_crt":
            kernels[-1]["wide_18_digits"] = wide_k2
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
        main_path_integer_s=round(t_integer, 3),
        main_path_integer_fused_s=round(t_fused, 3),
        main_path_parallel_s=round(t_parallel, 3),
        checkpoint_resume_s=round(t_checkpoint, 3),
        profiling_s=round(t_profiling, 3),
        main_path_batched_s=round(t_batched, 3),
        main_path_strings_s=round(t_strings, 3),
        main_path_pbs_ks_s=round(t_pbs_ks, 3),
        main_path_keys_s=round(t_keys, 3),
        main_path_wopbs_s=round(t_wopbs, 3),
        main_path_multibit_s=round(t_main_mb, 3),
        main_path_boolean_s=round(t_main_bool, 3),
        main_path_ntt_s=round(t_main_ntt, 3),
        main_path_u128_s=round(t_main_u128, 3),
        main_path_api_s=round(t_api, 3),
        main_path_multibit_ntt_s=round(t_main_mb_ntt, 3),
        main_path_examples_s=round(t_examples, 3))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
