"""Drive tfhe_tpu_torch on one NVIDIA card: build, check, run, time.

    python3 chip_smoke.py

Phases, each printing one flushed line with its wall time:
  1. card: the card's name and power limit (nvidia-smi) and torch's name;
  2. build: nvcc builds the blind-rotation kernels and g++ the native AES
     generator, from the sources in this checkout, at first use;
  3. kernels: each kernel against its plain PyTorch version at the main
     path's shapes (N=2048, G=2, L=1, base_log 23, 5 primes, B=64), one
     step each and a 4-step blind rotation, bit-exact (tolerance 0), with
     times per launch;
  4. main path: PARAM_MESSAGE_2_CARRY_2_KS_PBS keys generated on the card,
     64 messages covering all 16 message+carry values, three univariate LUTs
     and one bivariate LUT through the ServerKey entry points, every result
     decrypted and checked; then the same pipeline on a small insecure
     parameter set, on the card and on the CPU, bit-identical;
  5. timing: keyswitch_then_pbs throughput at B=64 and B=256 (host clock,
     launch overhead included), its split into keyswitch and blind
     rotation, and each kernel's device time per launch at B=256.
Kernel times are device times: a CUDA graph of many launches replayed
between CUDA events; the eager per-launch times beside them include the
host's launch cost.
Then a `kernels` JSON line, the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}.  Any failed phase raises, so the script exits
non-zero and prints no result; it needs a card and refuses to run without
one.  A watchdog ends a hung run with a traceback.
"""

import faulthandler
import json
import subprocess
import sys
import time

WATCHDOG_S = 600
SEED = 2024
B_MAIN = 64
B_LARGE = 256

# H100 SXM peaks (NVIDIA data sheet):
# 3.35 TB/s HBM3, and 67 T 32-bit operations/s outside the tensor cores,
# the rate the integer arithmetic of these kernels is held against.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12


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


def bounds_ms(B, G, L, N, P):
    """Least time for one launch of each kernel at these shapes: the larger
    of (bytes read once + written once) / bandwidth and operations / peak."""
    M = 2
    LJ = L * G
    k1_bytes = B * G * N * 8 + B * 4 + B * L * G * N * 4
    k1_ops = B * G * N * (10 + 8 * L)
    k2_bytes = (B * LJ * N * 4 + 2 * P * LJ * G * M * N * 4
                + 2 * B * G * N * 8)
    log_n = N.bit_length() - 1
    butterflies = B * P * (LJ + G * M) * (N // 2) * log_n
    k2_ops = (butterflies * 9                     # Shoup product + 2 mod adds
              + B * P * G * M * N * LJ * 7        # spectrum MAC
              + B * P * LJ * N * 4                # digits mod p
              + B * G * M * N * (P * (P - 1) // 2 * 7 + P * 10))  # Garner
    out = {}
    for name, nbytes, ops in (("rotate_decompose", k1_bytes, k1_ops),
                              ("external_product_crt", k2_bytes, k2_ops)):
        tb = nbytes / PEAK_BYTES_PER_S * 1e3
        to = ops / PEAK_OPS_PER_S * 1e3
        out[name] = (max(tb, to), "bytes" if tb >= to else "operations")
    return out


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
                                     programmable_bootstrap)
    from tfhe_tpu_torch.ops import fused_pbs
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
    fused_pbs.cuda_library()
    t_nvcc = time.time() - t0
    t1 = time.time()
    prng.native_library()
    t_gxx = time.time() - t1
    aes = prng.Aes128(0x0123456789ABCDEF, backend="native")
    ref = prng.Aes128(0x0123456789ABCDEF, backend="numpy")
    if not np.array_equal(aes.ctr_blocks(7, 64), ref.ctr_blocks(7, 64)):
        raise AssertionError("native AES disagrees with the numpy AES")
    say("build", t0, nvcc_s=round(t_nvcc, 3), gxx_s=round(t_gxx, 3),
        aes_backend=aes.backend)

    # -- 3. kernels against their plain versions ----------------------------
    t0 = time.time()
    p = PARAM_MESSAGE_2_CARRY_2_KS_PBS
    N, G, L, bl = p.polynomial_size, p.glwe_size, p.pbs_level, p.pbs_base_log
    P = 5
    rng = np.random.default_rng(SEED)

    def rand_u64(*shape):
        return torch.from_numpy(
            rng.integers(0, 2**64 - 1, shape, dtype=np.uint64,
                         endpoint=True).view(np.int64)).to(dev)

    steps = 4
    raw = rand_u64(steps, L, G, G, N)
    bsk = fused_pbs.prepare_bsk_cuda(raw, bl)
    acc = rand_u64(B_MAIN, G, N)
    ahat = torch.from_numpy(
        rng.integers(0, 2 * N, (steps, B_MAIN), endpoint=True)
        .astype(np.int32)).to(dev)

    dig_k = fused_pbs.rotate_decompose(acc, ahat[0], bl, L)
    dig_p = fused_pbs.rotate_decompose_plain(acc, ahat[0], bl, L)
    torch.cuda.synchronize()
    err_k1 = max_abs_err(dig_k, dig_p)
    acc_k = fused_pbs.external_product_crt(dig_p, bsk.kspec[0],
                                           bsk.kshoup[0], acc)
    acc_p = fused_pbs.external_product_crt_plain(dig_p, bsk.kspec[0], acc)
    torch.cuda.synchronize()
    err_k2 = max_abs_err(acc_k, acc_p)
    rot_k = fused_pbs.blind_rotate_fused(bsk, acc, ahat)
    rot_p = acc
    for i in range(steps):
        d = fused_pbs.rotate_decompose_plain(rot_p, ahat[i], bl, L)
        rot_p = fused_pbs.external_product_crt_plain(d, bsk.kspec[i], rot_p)
    torch.cuda.synchronize()
    err_rot = max_abs_err(rot_k, rot_p)
    if err_k1 or err_k2 or err_rot:
        raise AssertionError(
            f"kernels disagree with their plain versions: rotate_decompose "
            f"{err_k1}, external_product_crt {err_k2}, {steps}-step blind "
            f"rotation {err_rot}")

    k1 = lambda: fused_pbs.rotate_decompose(acc, ahat[0], bl, L)  # noqa: E731
    k2 = lambda: fused_pbs.external_product_crt(  # noqa: E731
        dig_p, bsk.kspec[0], bsk.kshoup[0], acc)
    ms_k1, ms_k2 = graph_ms(k1, 100), graph_ms(k2, 100)
    ms_k1_plain = graph_ms(lambda: fused_pbs.rotate_decompose_plain(
        acc, ahat[0], bl, L), 10)
    ms_k2_plain = graph_ms(lambda: fused_pbs.external_product_crt_plain(
        dig_p, bsk.kspec[0], acc), 3)
    say("kernels", t0, shape=dict(B=B_MAIN, G=G, L=L, N=N, P=P, base_log=bl),
        max_abs_err=dict(rotate_decompose=err_k1, external_product_crt=err_k2,
                         blind_rotation_4_steps=err_rot),
        device_ms_per_launch=dict(rotate_decompose=ms_k1,
                                  external_product_crt=ms_k2),
        eager_ms_per_launch=dict(rotate_decompose=cuda_ms(k1, 200),
                                 external_product_crt=cuda_ms(k2, 200)),
        plain_device_ms=dict(rotate_decompose=ms_k1_plain,
                             external_product_crt=ms_k2_plain))
    del raw, bsk, acc, dig_k, dig_p, acc_k, acc_p, rot_k, rot_p

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
    launches = {fn.__name__: fn.launches for fn in fused_pbs.KERNELS}
    t_main = time.time() - t0
    say("main_path", t0, params=p.name, batch=B_MAIN, keygen_s=t_keygen,
        correct=results, launches=launches)
    if any(v != B_MAIN for v in results.values()):
        raise AssertionError(f"wrong decryptions: {results} of {B_MAIN}")
    expected = 4 * p.lwe_dimension
    if any(v != expected for v in launches.values()):
        raise AssertionError(f"main path launched {launches}, expected "
                             f"{expected} of each kernel")

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

    # -- 5. timing ----------------------------------------------------------
    t0 = time.time()
    lut = sks.generate_lookup_table(lambda x: x % 4)
    rates, batch_ms, split_ms = {}, {}, {}
    for B in (B_MAIN, B_LARGE):
        data = cks.encrypt_batch(np.arange(B) % 16).data
        keyswitch_then_pbs(sks.ksk, sks.bsk, lut.acc, data)  # warm-up
        torch.cuda.synchronize()
        reps = 3
        t1 = time.time()
        for _ in range(reps):
            keyswitch_then_pbs(sks.ksk, sks.bsk, lut.acc, data)
        torch.cuda.synchronize()
        dt = (time.time() - t1) / reps
        rates[str(B)] = B / dt
        batch_ms[str(B)] = dt * 1e3
        small_ct = keyswitch(sks.ksk, data)
        split_ms[str(B)] = dict(
            keyswitch=cuda_ms(lambda: keyswitch(sks.ksk, data), 3),
            blind_rotate_and_extract=cuda_ms(lambda: programmable_bootstrap(
                sks.bsk, lut.acc, small_ct), 2, warmup=0))
    acc = torch.zeros((B_LARGE, G, N), dtype=torch.int64, device=dev)
    acc[:, -1] = lut.acc[-1]
    ahat = torch.from_numpy(rng.integers(0, 2 * N, (B_LARGE,))
                            .astype(np.int32)).to(dev)
    dig = fused_pbs.rotate_decompose(acc, ahat, bl, L)
    ms256_k1 = graph_ms(lambda: fused_pbs.rotate_decompose(acc, ahat, bl, L),
                        100)
    ms256_k2 = graph_ms(lambda: fused_pbs.external_product_crt(
        dig, sks.bsk.kspec[0], sks.bsk.kshoup[0], acc), 100)
    say("timing", t0, card=card, pbs_per_s=rates, batch_ms=batch_ms,
        batch_split_ms=split_ms, device_ms_per_launch_b256=dict(
            rotate_decompose=ms256_k1, external_product_crt=ms256_k2),
        bound_ms_b256={k: v[0] for k, v in
                       bounds_ms(B_LARGE, G, L, N, P).items()})

    bounds = bounds_ms(B_MAIN, G, L, N, P)
    kernels = []
    for name, ms, plain_ms, err, line in (
            ("rotate_decompose", ms_k1, ms_k1_plain, err_k1, 1229),
            ("external_product_crt", ms_k2, ms_k2_plain, err_k2, 1244)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "tfhe_tpu_torch/ops/csrc/pbs_kernels.cuh",
            "replaces": f"tfhe_tpu/ops/fused_pbs.py:{line}",
            "launches": launches[name], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bounds[name][0],
            "bound_by": bounds[name][1], "library_ms": None})
    say("done", t_start, main_path_s=round(t_main, 3))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
