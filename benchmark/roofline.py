"""The least time the card could take for a PBS batch, and the card's peaks.

One step of the classic blind rotation: rotate and decompose the
accumulator, then the external product through the NTT with its CRT.
`least_step_work` counts the least the card must do for it, whatever
kernels and whatever CRT carry it: the accumulator read once and written
once, the step's key in its plain form read once, and the operations of
the arithmetic (a Shoup product counts 6 operations, a modular add 3, a
butterfly 9) with the fewest primes and key planes that hold the exact
product, derived from the parameter set's bit widths.  The metric
`pbs_roofline` reads that.

`step_work` is a frozen copy of `classic_work` (chip_smoke.py) reduced to
the scan2 step: the work of the program's own algorithm (five primes, two
key planes, the spectra's Shoup companions), kept to restate the smoke's
older bounds.

Peaks: HBM3 at 3.35 TB/s (NVIDIA H100 SXM data sheet).  The kernels'
operations are 32-bit integer instructions, which a Hopper SM issues on
64 INT32 lanes a clock (NVIDIA H100 Tensor Core GPU Architecture
whitepaper), so the integer peak is SMs x 64 x the maximum SM clock, read
from the card at run time.  The data sheet's 67 T/s is the FP32 rate (128
lanes, a fused multiply-add counted twice); `LEGACY_PEAK_OPS_PER_S` keeps
it for comparison with the older bounds.
"""

from __future__ import annotations

import subprocess

PEAK_BYTES_PER_S = 3.35e12
# the primes of the kernels' CRT (tfhe_tpu_torch/ops/ntt.py PRIMES), for
# the frozen copy of the smoke's counts only
CRT_PRIMES = 5
# the widest NTT prime a 32-bit word holds, for the least work
PRIME_BITS = 31
INT32_LANES_PER_SM = 64
LEGACY_PEAK_OPS_PER_S = 67e12


def _step_ops(B: int, G: int, L: int, N: int, P: int, M: int):
    """(K1's, K2's) operations of one step over B ciphertexts with P primes
    and M key planes a torus word."""
    LJ, OM = L * G, G * M
    log_n = N.bit_length() - 1
    k1_ops = B * G * N * (10 + 8 * L)
    butterflies = B * P * (LJ + OM) * (N // 2) * log_n
    mac_ops = (butterflies * 9                # Shoup product + 2 mod adds
               + B * P * OM * N * LJ * 7      # spectrum MAC
               + B * P * LJ * N * 4)          # digits mod p
    garner = B * OM * N * (P * (P - 1) // 2 * 7 + P * 10)
    return k1_ops, mac_ops + garner


def step_work(B: int, G: int, L: int, N: int, P: int, bits: int = 64):
    """{part: (bytes, operations)} of one blind-rotation step over B
    ciphertexts as the program's kernels do it (P primes, 2 key planes a
    64-bit word, Shoup companions beside the spectra): "rotate_decompose"
    and "external_product_crt" as the smoke's classic_work counts one
    launch of each, and "step", the two together with the digits kept on
    chip."""
    M = 2 if bits == 64 else 1
    LJ, OM = L * G, G * M
    acc = B * G * N * 8
    key = 2 * P * LJ * OM * N * 4  # one step's spectra and companions
    k1_ops, k2_ops = _step_ops(B, G, L, N, P, M)
    return {
        "rotate_decompose": (acc + B * 4 + B * LJ * N * 4, k1_ops),
        "external_product_crt": (B * LJ * N * 4 + key + 2 * acc, k2_ops),
        "step": (2 * acc + B * 4 + key, k1_ops + k2_ops),
    }


def crt_primes(base_log: int, L: int, G: int, N: int, plane_bits: int,
               prime_bits: int = PRIME_BITS) -> int:
    """The fewest primes below 2**prime_bits whose product exceeds twice
    the largest exact sum of L*G products of a balanced digit (at most
    2**(base_log-1)) and a signed key plane of plane_bits bits over N
    terms: what the external product needs, whatever the kernels use."""
    mag_bits = (base_log - 1) + (plane_bits - 1) + (L * G * N - 1).bit_length()
    return -(-(mag_bits + 1) // prime_bits)


def least_step_work(B: int, G: int, L: int, N: int, base_log: int,
                    bits: int = 64):
    """(bytes, operations, P, M): the least one blind-rotation step over B
    ciphertexts needs.  Operations: the NTT external product with the key
    word split into M planes (1, 2 or 4, whichever needs fewest) and, for
    each, the fewest primes below 2**31 that hold the exact product
    (`crt_primes`), not the program's own P and M.  Bytes: the accumulator
    read and written once, the rotation amounts, and the step's key in its
    plain form (L*G*G torus polynomials), with no spectra or companions."""
    best = None
    for M in (1, 2, 4):
        P = crt_primes(base_log, L, G, N, bits // M)
        ops = sum(_step_ops(B, G, L, N, P, M))
        if best is None or ops < best[0]:
            best = (ops, P, M)
    word = bits // 8
    nbytes = 2 * B * G * N * word + B * 4 + L * G * G * N * word
    return nbytes, best[0], best[1], best[2]


def bound_s(nbytes: float, ops: float, peak_ops_per_s: float,
            peak_bytes_per_s: float = PEAK_BYTES_PER_S):
    """(least seconds, "bytes" or "operations", whichever bounds)."""
    tb = nbytes / peak_bytes_per_s
    to = ops / peak_ops_per_s
    return (tb, "bytes") if tb >= to else (to, "operations")


def pbs_batch_min_s(rows: int, steps: int, G: int, L: int, N: int,
                    base_log: int, peak_ops_per_s: float,
                    bits: int = 64) -> float:
    """Least seconds for the blind rotation of one batch of `rows`
    ciphertexts: `steps` (n) steps, each at the bound of its least work."""
    nbytes, ops, _, _ = least_step_work(rows, G, L, N, base_log, bits)
    return steps * bound_s(nbytes, ops, peak_ops_per_s)[0]


def device_peaks(index: int = 0) -> dict:
    """The card's integer-operation peak, derived now: SM count from
    torch, maximum SM clock and power limit from nvidia-smi."""
    import torch

    props = torch.cuda.get_device_properties(index)
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}",
         "--query-gpu=name,clocks.max.sm,power.limit",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    name, clock_mhz, power_w = (f.strip() for f in
                                out.strip().splitlines()[0].split(","))
    sms = props.multi_processor_count
    return {
        "card": name,
        "sm_count": sms,
        "max_sm_clock_mhz": float(clock_mhz),
        "power_limit_w": float(power_w),
        "int32_ops_per_s": sms * INT32_LANES_PER_SM * float(clock_mhz) * 1e6,
        "bytes_per_s": PEAK_BYTES_PER_S,
    }


def main() -> None:
    """Print the derived peak; for the classic set's shapes (n = 742
    steps, G = 2, L = 1, N = 2048, base_log 23) the least step bound at
    the integer peak, and the program's step (P = 5) at both peaks."""
    import json

    peaks = device_peaks()
    rows = {}
    for B in (64, 256, 512):
        nbytes, ops, P, M = least_step_work(B, 2, 1, 2048, 23)
        rows[B] = {"least": {"P": P, "M": M, "int_peak_ms": bound_s(
            nbytes, ops, peaks["int32_ops_per_s"])[0] * 1e3}}
        for part, (nb, ops) in step_work(B, 2, 1, 2048, CRT_PRIMES).items():
            rows[B][part] = {
                "int_peak_ms": bound_s(nb, ops,
                                       peaks["int32_ops_per_s"])[0] * 1e3,
                "fp32_peak_ms": bound_s(nb, ops,
                                        LEGACY_PEAK_OPS_PER_S)[0] * 1e3}
    print(json.dumps({"peaks": peaks, "step_bounds": rows}))


if __name__ == "__main__":
    main()
