"""Multi-bit blind rotation on hand-written CUDA kernels, and their plain
versions.

Port of `tfhe_tpu/ops/fused_multibit.py`.  One group step of gf mask
elements replaces the accumulator by the external product of the combined
GGSW K_0 + sum_{j>=1} X^{d_j} K_j with it (ref: core_crypto/algorithms/
lwe_multi_bit_programmable_bootstrapping.rs:295-460), in n/gf steps.  The
TPU has two schedules of that step, and so has the port, chosen by the
explicit `mode` argument of `multi_bit_blind_rotate_cuda`:

  "scan3" (default; K8, `fused_multibit_rotate_scan` :702, default at :927),
  two launches a group step:
      multibit_combine           the per-ciphertext combined key spectra
                                 (K8 singles_kernel :747 + combine_kernel
                                 :776), written to device memory;
      multibit_external_product  from the accumulator: its signed gadget
                                 digits (K8 mac_kernel's `_dec_limbs` :264),
                                 forward NTT, MAC against the combined key,
                                 inverse NTT, CRT into a fresh accumulator
                                 (K8 mac_kernel :823);
  "scan1" (K9, `fused_multibit_rotate_scan1` :508 -> step_kernel :539)
      multibit_step              the whole group step in one launch: the
                                 digits, the same external product with the
                                 key combination inside the MAC, and the
                                 CRT; the combined key and the digits never
                                 reach device memory.

The kernels are CUDA C++ for sm_90a, built by nvcc at first use and called
through ctypes: K8's combine in `csrc/multibit_kernels.cuh`; K8's external
product and K9 on the register-resident NTT core (`csrc/multibit_core.cuh`
on `csrc/ntt_core.cuh`), one cluster of a CTA per prime per ciphertext,
one kernel with the key per ciphertext (K8) or the subsets combined inside
the MAC (K9).  scan3 materialises the combined key and scan1 does not, so
each checks the other.  Each wrapper takes its plain PyTorch version
(`*_plain`) for CPU tensors, launches its kernel for CUDA tensors, and
raises for anything else; each counts its launches in its `launches`
attribute (a counter of `utils.profiling`, which a CUDA graph's replay
adds to).  The wrappers check dtypes and shapes; the C entry points
reject a layout beyond the kernels' limits (subsets, outputs, the core's
digit polynomials, shared memory), which `_check_launch` raises.

The subset keys are transformed once by `prepare_multi_bit_bsk_cuda`, on
the prime set and planes that `ntt.classic_plan` gives the parameter set's
widths for a key word summed from 2^gf words (four of `ntt.WIDE_PRIMES`
and one plane at every copied set with N <= 2048, where the reference's
five primes below 2^17 took two planes); the kernels read the set's P and
M from the key.  The monomial spectra come from the set's table of powers
of psi in `ops/ntt.py`.  Every wrapper and plain version takes the key's
set as `primes` (the wrappers as a keyword), defaulting to the reference's
`ntt.PRIMES`, and refuses a key of another set.  The TPU's
epsilon-corrected products of singleton monomials, int16/int8 key split,
prime groups and 128/8 batch alignment are TPU scheduling and have no
counterpart here.
"""

from __future__ import annotations

import ctypes
import functools
import os
from dataclasses import dataclass

import torch

from .._native import build_shared_library
from ..utils import profiling
from . import ntt
from .decomposition import signed_decompose
from .fused_pbs import (_CORE_HEADERS, BUILD_TIMEOUT_S, NVCC_FLAGS, _check,
                        _check_aligned, _check_key_set, _check_launch,
                        _headers, _nvcc, _stream, bsk_spectra, digit_spectra,
                        spectra_to_u64, spectral_mac)

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
MODES = ("scan3", "scan1")


def check_mode(mode: str) -> None:
    """Raises unless `mode` is one of `MODES`."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")


BITS = 64  # every multi-bit parameter set is on the 64-bit torus


@functools.cache
def cuda_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the multi-bit kernels' shared
    library.  Raises `tfhe_tpu_torch._native.BuildError` with nvcc's
    stderr."""
    path = build_shared_library(
        "multibit_kernels", [os.path.join(_CSRC, "multibit_kernels.cu")],
        [_nvcc(), *NVCC_FLAGS], timeout=BUILD_TIMEOUT_S,
        headers=_headers("multibit_kernels.cuh", "multibit_core.cuh",
                         "pbs_kernels.cuh", *_CORE_HEADERS))
    lib = ctypes.CDLL(path)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.tfhe_multibit_combine.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
    lib.tfhe_multibit_external_product.argtypes = ([ptr] * 5 + [i32] * 7
                                                   + [ptr])
    lib.tfhe_multibit_step.argtypes = [ptr] * 8 + [i32] * 8 + [ptr]
    for fn in (lib.tfhe_multibit_combine, lib.tfhe_multibit_external_product,
               lib.tfhe_multibit_step):
        fn.restype = i32
    return lib


def _device_of(name: str, t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device.type


def decompose_plain(acc: torch.Tensor, base_log: int,
                    levels: int) -> torch.Tensor:
    """acc [B, G, N] int64 -> digits [B, L, G, N] int32 of
    signed_decompose(acc): the digits K8's external product and K9 make
    inside (`_dec_limbs`, tfhe_tpu/ops/fused_multibit.py:264)."""
    digits = signed_decompose(acc, base_log, levels, bits=BITS)
    return digits.permute(0, 3, 1, 2).contiguous()


# ---------------------------------------------------------------------------
# K8: combine, then the external product with the combined key
# ---------------------------------------------------------------------------


def _check_group_key(kspec: torch.Tensor, dev: torch.device) -> tuple:
    per, P, LJ, O, M, N = kspec.shape
    _check("kspec", kspec, torch.int32, (per, P, LJ, O, M, N), dev)
    if per & (per - 1):
        raise ValueError(f"group key layout per={per} not supported")
    return per, P, LJ, O, M, N


def multibit_combine_plain(d: torch.Tensor, kspec: torch.Tensor,
                           primes: tuple[int, ...] = ntt.PRIMES
                           ) -> torch.Tensor:
    """d [B, per] int32 in [0, 2N), kspec [per, P, LJ, O, M, N] (canonical
    residues over `primes`) -> combined [B, P, LJ, O, M, N] int32:
    K_0 + sum_{j>=1} spec(X^{d_j}) * K_j mod p."""
    per, P, LJ, O, _, N = kspec.shape
    p = ntt.tables_for(N, kspec.device, primes).primes.view(1, P, 1, 1, 1, 1)
    mon = ntt.monomial_spectra(d, N, primes)  # [B, per, P, N]
    key = kspec.to(torch.int64)
    out = key[0].unsqueeze(0).expand(d.shape[0], -1, -1, -1, -1, -1)
    for j in range(1, per):
        term = key[j][None] * mon[:, j, :, None, None, None, :] % p
        out = (out + term) % p
    return out.to(torch.int32).contiguous()


def multibit_combine(d: torch.Tensor, kspec: torch.Tensor, *,
                     primes: tuple[int, ...] = ntt.PRIMES) -> torch.Tensor:
    """Per-ciphertext combined key spectra over the key's set `primes`
    (replaces K8's singles_kernel, tfhe_tpu/ops/fused_multibit.py:747, and
    combine_kernel, :776): `multibit_combine_kernel`, a block holding a
    tile of the subset keys in shared memory for 8 ciphertexts, a thread
    owning one ciphertext's 8 consecutive words of each key row.  The
    launch is refused past 2^gf = 16 subsets or below N = 256.  Every call
    on a non-empty batch, launch or plain version, adds the bytes of the
    subset spectra it is handed to `COMBINE_KEY_BYTES`."""
    if d.shape[0]:
        COMBINE_KEY_BYTES.value += kspec.numel() * kspec.element_size()
    _check_key_set("multibit_combine", kspec.shape[1], kspec.shape[-2], BITS,
                   primes)
    if _device_of("multibit_combine", d) == "cpu":
        return multibit_combine_plain(d, kspec, primes)
    dev = d.device
    per, P, LJ, O, M, N = _check_group_key(kspec, dev)
    B = d.shape[0]
    _check("d", d, torch.int32, (B, per), dev)
    _check_aligned("kspec", kspec)
    out = torch.empty((B, P, LJ, O, M, N), dtype=torch.int32, device=dev)
    if B == 0:
        return out
    mono = ntt.monomial_tables_for(N, dev, primes)
    err = cuda_library().tfhe_multibit_combine(
        d.data_ptr(), kspec.data_ptr(), mono.powers.data_ptr(),
        mono.exponents.data_ptr(),
        ntt.pass_tables_for(N, dev, primes).data_ptr(), out.data_ptr(), B,
        per, P, LJ * O * M * N, N, _stream(dev))
    _check_launch(err, "multibit_combine")
    multibit_combine.launches += 1
    return out


multibit_combine.launches = 0
# the subset-spectra bytes handed to the combine, every call
COMBINE_KEY_BYTES = profiling.counter(
    "fused_multibit.multibit_combine.key_bytes")


def multibit_external_product_plain(acc: torch.Tensor,
                                    combined: torch.Tensor, base_log: int,
                                    levels: int,
                                    primes: tuple[int, ...] = ntt.PRIMES
                                    ) -> torch.Tensor:
    """acc [B, G, N] int64, combined [B, P, LJ, G, M, N] over `primes` ->
    the new accumulator [B, G, N] int64: sum_lj D_lj (x) K_lj (mod 2^64)
    over the signed digits D of acc itself."""
    return spectra_to_u64(spectral_mac(digit_spectra(decompose_plain(
        acc, base_log, levels), primes), combined, primes), BITS, primes)


def multibit_external_product(acc: torch.Tensor, combined: torch.Tensor,
                              base_log: int, levels: int, *,
                              primes: tuple[int, ...] = ntt.PRIMES
                              ) -> torch.Tensor:
    """External product of the accumulator with a key per ciphertext over
    the key's set `primes`, into a fresh accumulator (replaces K8's
    mac_kernel, tfhe_tpu/ops/fused_multibit.py:823, which takes the
    accumulator and makes its digits inside, :828): K9's kernel
    `multibit_step_cluster_kernel` with one subset and the combined key,
    one launch, a cluster of one CTA per prime and ciphertext.  The core takes 256 <= N <= 2048
    (`ntt.pass_tables_for` raises otherwise) and L*G <= 18, the kernel
    G * M <= 8: the launch is refused otherwise."""
    P, M = combined.shape[1], combined.shape[-2]
    _check_key_set("multibit_external_product", P, M, BITS, primes)
    if _device_of("multibit_external_product", acc) == "cpu":
        return multibit_external_product_plain(acc, combined, base_log,
                                               levels, primes)
    dev = acc.device
    B, G, N = acc.shape
    _check("acc", acc, torch.int64, (B, G, N), dev)
    _check("combined", combined, torch.int32,
           (B, P, levels * G, G, M, N), dev)
    _check_aligned("combined", combined)
    if BITS - base_log * levels < 1:
        raise ValueError("the decomposition must leave at least one bit")
    tables = ntt.pass_tables_for(N, dev, primes)
    out = torch.empty_like(acc)
    if B == 0:  # a grid of zero blocks is an invalid launch
        return out
    err = cuda_library().tfhe_multibit_external_product(
        acc.data_ptr(), combined.data_ptr(), tables.data_ptr(),
        ntt.tables_for(N, dev, primes).xcrt.data_ptr(), out.data_ptr(), B,
        G, M, P, N, base_log, levels, _stream(dev))
    _check_launch(err, "multibit_external_product")
    multibit_external_product.launches += 1
    return out


multibit_external_product.launches = 0


# ---------------------------------------------------------------------------
# K9: the whole step in one kernel
# ---------------------------------------------------------------------------


def multibit_step_plain(acc: torch.Tensor, d: torch.Tensor,
                        kspec: torch.Tensor, base_log: int, levels: int,
                        primes: tuple[int, ...] = ntt.PRIMES
                        ) -> torch.Tensor:
    """acc [B, G, N] int64, d [B, 2^gf] int32 in [0, 2N), kspec [2^gf, P,
    LJ, G, M, N] (canonical residues over `primes`) -> the new accumulator
    [B, G, N] int64: the digits of acc, then the kernel's order of the
    MAC, sum_j spec(X^{d_j}) * (sum_lj D_lj * K_j) with spec(X^{d_0}) = 1,
    then the CRT into a fresh accumulator; the same words as combine, then
    the external product."""
    per, P, LJ, O, _, N = kspec.shape
    p = ntt.tables_for(N, kspec.device, primes).primes.view(1, P, 1, 1, 1)
    dspec = digit_spectra(decompose_plain(acc, base_log, levels), primes)
    mon = ntt.monomial_spectra(d, N, primes)  # [B, per, P, N]
    spec = spectral_mac(dspec, kspec[0][None], primes)
    for j in range(1, per):
        t = spectral_mac(dspec, kspec[j][None], primes)  # [B, P, O, M, N]
        spec = (spec + t * mon[:, j, :, None, None, :] % p) % p
    return spectra_to_u64(spec, BITS, primes)


def multibit_step(acc: torch.Tensor, d: torch.Tensor, kspec: torch.Tensor,
                  base_log: int, levels: int, *,
                  primes: tuple[int, ...] = ntt.PRIMES) -> torch.Tensor:
    """One whole group step in one launch over the key's set `primes`
    (replaces K9's step_kernel, tfhe_tpu/ops/fused_multibit.py:539):
    `multibit_step_cluster_kernel`, a cluster of one CTA per prime and
    ciphertext on the register-resident NTT core, the digits made inside,
    the subset keys combined inside the MAC (which reads no key
    companions), the explicit CRT in the same launch.  Returns a new
    accumulator.  The core takes 256 <= N <= 2048 (`ntt.pass_tables_for`
    raises otherwise) and L*G <= 18; the kernel 2^gf <= 16 subsets and
    G * M <= 8: the launch is refused otherwise."""
    _check_key_set("multibit_step", kspec.shape[1], kspec.shape[-2], BITS,
                   primes)
    if _device_of("multibit_step", acc) == "cpu":
        return multibit_step_plain(acc, d, kspec, base_log, levels, primes)
    dev = acc.device
    per, P, LJ, O, M, N = _check_group_key(kspec, dev)
    B, G, _ = acc.shape
    _check("acc", acc, torch.int64, (B, G, N), dev)
    _check("d", d, torch.int32, (B, per), dev)
    _check_aligned("kspec", kspec)
    if LJ != levels * G or O != G or BITS - base_log * levels < 1:
        raise ValueError(f"key layout LJ={LJ}, O={O} does not match acc "
                         f"{tuple(acc.shape)} at {levels} levels of "
                         f"{base_log} bits")
    tables = ntt.pass_tables_for(N, dev, primes)
    mono = ntt.monomial_tables_for(N, dev, primes)
    out = torch.empty_like(acc)
    if B == 0:  # a grid of zero blocks is an invalid launch
        return out
    err = cuda_library().tfhe_multibit_step(
        acc.data_ptr(), d.data_ptr(), kspec.data_ptr(),
        mono.powers.data_ptr(), mono.exponents.data_ptr(), tables.data_ptr(),
        ntt.tables_for(N, dev, primes).xcrt.data_ptr(), out.data_ptr(), B,
        per, G, M, P, N, base_log, levels, _stream(dev))
    _check_launch(err, "multibit_step")
    multibit_step.launches += 1
    return out


multibit_step.launches = 0

KERNELS = (multibit_combine, multibit_external_product, multibit_step)
profiling.register_launches("fused_multibit", KERNELS)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


# ---------------------------------------------------------------------------
# prepared key and the group-step loop
# ---------------------------------------------------------------------------


@dataclass
class PreparedMultiBitBskCuda:
    """Multi-bit BSK as NTT spectra in the kernels' layout: kspec
    [n/gf, 2^gf, P, L*G, G, M, N] int32 (bit patterns of canonical uint32
    residues over the P primes of `primes`; M planes a torus word), one
    [2^gf, P, ...] block per group step.  No kernel of either schedule
    reads Shoup companions of these keys, so none are kept."""

    kspec: torch.Tensor
    base_log: int
    levels: int
    glwe_size: int
    polynomial_size: int
    input_dim: int
    grouping_factor: int
    primes: tuple[int, ...]

    @property
    def planes(self) -> int:
        return self.kspec.shape[-2]


def prepare_multi_bit_bsk_cuda(raw_bsk: torch.Tensor, base_log: int,
                               grouping_factor: int,
                               primes: tuple[int, ...] | None = None
                               ) -> PreparedMultiBitBskCuda:
    """Standard-domain multi-bit BSK [n/gf, 2^gf, L, G (row), G (poly), N]
    int64 on the 64-bit torus -> its subset spectra, computed on the key's
    device in chunks (counterpart of prepare_multi_bit_bsk_ntt,
    tfhe_tpu/core/multibit.py:163, and prepare_multi_bit_bsk_fused,
    tfhe_tpu/ops/fused_multibit.py:233).  The set of primes and the planes
    a word follow from the parameter set's widths (`ntt.classic_plan` for
    a key word summed from 2^gf words); `primes` names another set (the
    reference's `ntt.PRIMES`, to compare spectra with it), on which the
    key takes the fewest planes that hold the product."""
    n_groups, per, L, J, O, N = raw_bsk.shape
    if per != 1 << grouping_factor:
        raise ValueError(f"{per} GGSWs per group, expected "
                         f"2^{grouping_factor}")
    if primes is None:
        primes, M = ntt.classic_plan(base_log, L, J, N, BITS, per)
    else:
        primes = tuple(primes)
        M = ntt.planes_for(primes, base_log, L, J, N, BITS, per)
    kspec = bsk_spectra(raw_bsk.reshape(n_groups * per, L, J, O, N), BITS,
                        primes, M)
    return PreparedMultiBitBskCuda(
        kspec=kspec.view((n_groups, per) + tuple(kspec.shape[1:])),
        base_log=base_log, levels=L, glwe_size=J, polynomial_size=N,
        input_dim=n_groups * grouping_factor,
        grouping_factor=grouping_factor, primes=primes)


def multi_bit_blind_rotate_cuda(bsk: PreparedMultiBitBskCuda,
                                acc: torch.Tensor, d_all: torch.Tensor,
                                mode: str = "scan3") -> torch.Tensor:
    """The group-step loop: acc [B, G, N] int64 (already rotated by X^-b),
    d_all [n/gf, B, 2^gf] int32 switched subset sums mod 2N -> rotated
    accumulator.  `mode` picks the schedule: "scan3" (K8, two launches a
    group step: combine, then the external product) or "scan1" (K9,
    one)."""
    check_mode(mode)
    acc = acc.contiguous()
    primes = bsk.primes
    for g in range(bsk.input_dim // bsk.grouping_factor):
        if mode == "scan1":
            acc = multibit_step(acc, d_all[g], bsk.kspec[g], bsk.base_log,
                                bsk.levels, primes=primes)
            continue
        combined = multibit_combine(d_all[g], bsk.kspec[g], primes=primes)
        acc = multibit_external_product(acc, combined, bsk.base_log,
                                        bsk.levels, primes=primes)
    return acc
