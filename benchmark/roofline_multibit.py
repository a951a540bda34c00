"""The least time the card could take for a multi-bit PBS batch, and for
each of the two kernels of its default schedule.

One group step of the multi-bit blind rotation (grouping factor gf, 2^gf
subset keys a group, n/gf steps a batch) over B ciphertexts replaces the
accumulator by its external product with the combined key
K_0 + sum_{j>=1} X^{d_j} K_j, one per ciphertext.  Its least work comes
from the parameter set alone, as `roofline.least_step_work` does for a
classic step: the fewest primes P and key planes M that hold the exact
product (`roofline.least_step_work`'s choice), whatever primes, planes or
schedule the program uses.

- The external product: `roofline.least_step_work`'s operations (the
  accumulator's rotation and decomposition, the NTTs, the MAC and the
  CRT).
- Combining the 2^gf subset keys for each ciphertext, the cheaper of two
  forms.  Spectral: each of the 2^gf - 1 subsets' spectra times its
  monomial's spectrum and added (a Shoup product, 6 operations, and a
  modular add, 3, a word), each monomial spectrum word made from a table
  of powers (its exponent's product and mask, 2).  Coefficient domain:
  each subset's plain key rotated negacyclically and added (a 64-bit add
  or subtract as two 32-bit words with carry, 2 a word, and 2 a
  coefficient for the index and the sign), then the combined key split
  into its M planes, each plane word reduced by each prime (a Shoup
  product and a modular add, 9) and transformed forward (9 a butterfly).
- Bytes: the accumulator read and written once, the gf mask words a
  ciphertext, and the group's 2^gf subset keys once in their plain form
  (L*G*G torus polynomials each), with no spectra.

The kernels of the default schedule ("scan3") split the step in two, so
each kernel's least bytes hold the combined key it hands on: the combine
writes the combined spectra once (B ciphertexts, P primes, L*G rows of
G*M polynomials, 32-bit residues) and the external product reads them
once.  `mb_pbs_roofline`, `kernels.mb_combine_roofline` and
`kernels.mb_external_product_roofline` read these counts.
"""

from __future__ import annotations

from benchmark import roofline

SHOUP_MUL_OPS = 6
MOD_ADD_OPS = 3
BUTTERFLY_OPS = 9
MONOMIAL_WORD_OPS = 2     # a monomial spectrum word: exponent product, mask
WORD64_ADD_OPS = 2        # a 64-bit add or subtract on two 32-bit words
ROTATE_INDEX_OPS = 2      # a rotated coefficient's index and sign
# the trace's names of the default schedule's two kernels
COMBINE_KERNEL = "multibit_combine_kernel"
EXTERNAL_PRODUCT_KERNEL = ("multibit_step_cluster_kernel<", ", true>")


def least_plan(G: int, L: int, N: int, base_log: int, bits: int = 64):
    """(P, M): the fewest primes and the key planes of the least external
    product (`roofline.least_step_work`; its choice does not depend on
    B)."""
    return roofline.least_step_work(1, G, L, N, base_log, bits)[2:]


def combine_ops(B: int, gf: int, G: int, L: int, N: int, base_log: int,
                bits: int = 64):
    """{"spectral": ops, "coefficient": ops} of combining the 2^gf subset
    keys of one group for B ciphertexts, at the least plan's P and M."""
    P, M = least_plan(G, L, N, base_log, bits)
    LJ, OM, others = L * G, G * M, (1 << gf) - 1
    log_n = N.bit_length() - 1
    spectral = B * others * (P * LJ * OM * N * (SHOUP_MUL_OPS + MOD_ADD_OPS)
                             + P * N * MONOMIAL_WORD_OPS)
    coefficient = B * (
        others * (LJ * G * N * WORD64_ADD_OPS + N * ROTATE_INDEX_OPS)
        + P * LJ * OM * N * (SHOUP_MUL_OPS + MOD_ADD_OPS)
        + P * LJ * OM * (N // 2) * log_n * BUTTERFLY_OPS)
    return {"spectral": spectral, "coefficient": coefficient}


def _combined_bytes(B, G, L, N, base_log, bits):
    """The combined key spectra of B ciphertexts at the least plan."""
    P, M = least_plan(G, L, N, base_log, bits)
    return B * P * (L * G) * (G * M) * N * 4


def _plain_group_key_bytes(gf, G, L, N, bits):
    return (1 << gf) * L * G * G * N * (bits // 8)


def group_step_work(B: int, gf: int, G: int, L: int, N: int, base_log: int,
                    bits: int = 64):
    """(bytes, operations) of one whole group step over B ciphertexts."""
    word = bits // 8
    _, ext_ops, _, _ = roofline.least_step_work(B, G, L, N, base_log, bits)
    ops = ext_ops + min(combine_ops(B, gf, G, L, N, base_log,
                                    bits).values())
    nbytes = (2 * B * G * N * word + B * gf * word
              + _plain_group_key_bytes(gf, G, L, N, bits))
    return nbytes, ops


def combine_work(B: int, gf: int, G: int, L: int, N: int, base_log: int,
                 bits: int = 64):
    """(bytes, operations) of the combine alone: the group's plain key and
    the mask words read once, the combined spectra written once."""
    word = bits // 8
    ops = min(combine_ops(B, gf, G, L, N, base_log, bits).values())
    nbytes = (_plain_group_key_bytes(gf, G, L, N, bits) + B * gf * word
              + _combined_bytes(B, G, L, N, base_log, bits))
    return nbytes, ops


def external_product_work(B: int, G: int, L: int, N: int, base_log: int,
                          bits: int = 64):
    """(bytes, operations) of the external product with a key a
    ciphertext: the accumulator read and written once, the combined
    spectra read once."""
    word = bits // 8
    _, ops, _, _ = roofline.least_step_work(B, G, L, N, base_log, bits)
    nbytes = (2 * B * G * N * word
              + _combined_bytes(B, G, L, N, base_log, bits))
    return nbytes, ops


def shapes(parameters: dict):
    """(steps, gf, G, L, N, base_log, bits) of a configuration's
    parameters, or None for a classic set."""
    gf = parameters.get("grouping_factor")
    if not gf:
        return None
    return (parameters["lwe_dimension"] // gf, gf,
            parameters["glwe_dimension"] + 1, parameters["pbs_level"],
            parameters["polynomial_size"], parameters["pbs_base_log"],
            parameters["torus_bits"])


def batch_min_s(part: str, rows: int, parameters: dict,
                peak_ops_per_s: float) -> float:
    """Least seconds of one multi-bit batch of `rows` ciphertexts: its n/gf
    group steps ("step"), or their combines ("combine") or external
    products ("external_product"), each at the larger of its bytes over
    3.35 TB/s and its operations over `peak_ops_per_s`."""
    steps, gf, G, L, N, base_log, bits = shapes(parameters)
    if part == "step":
        work = group_step_work(rows, gf, G, L, N, base_log, bits)
    elif part == "combine":
        work = combine_work(rows, gf, G, L, N, base_log, bits)
    elif part == "external_product":
        work = external_product_work(rows, G, L, N, base_log, bits)
    else:
        raise KeyError(part)
    return steps * roofline.bound_s(*work, peak_ops_per_s)[0]


def traced_least_s(run, part: str):
    """`batch_min_s` of `part` summed over the traced slice's PBS batches
    (the benchmark's counter's row counts), or None for a classic
    configuration or a run without the card's peaks."""
    p = run.config["parameters"]
    if not run.trace or not run.peaks or shapes(p) is None:
        return None
    peak = run.peaks["int32_ops_per_s"]
    return sum(batch_min_s(part, rows, p, peak)
               for r in run.traced for rows in r.rows)


def kernel_share(run, part: str, name) -> float | None:
    """`part`'s least time over the traced slice as a percentage of the
    device time of the kernels whose name holds `name` (a string, or a
    tuple of strings that must all appear); None where the trace holds no
    such kernel."""
    least = traced_least_s(run, part)
    if least is None:
        return None
    parts = (name,) if isinstance(name, str) else name
    spent = sum(s for n, s in run.trace["device_ops"]
                if all(p in n for p in parts))
    return 100.0 * least / spent if spent > 0 else None

