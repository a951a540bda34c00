"""Classic blind rotation on hand-written CUDA kernels, in six schedules,
and the kernels' plain versions.

Port of `tfhe_tpu/ops/fused_pbs.py`.  The reference picks one of its TPU
schedules with the environment variable TFHE_TPU_FUSED_MODE (:1568-1581);
here `blind_rotate_fused(..., mode=...)` takes it as an argument, one of
`MODES`, and raises on any other value:

  "scan2" (the default; K1 + K2, `fused_blind_rotate_scan2` :1213)
      rotate_decompose      K1 (`rot_kernel` :1229): negacyclic rotation of
                            the accumulator by X^{a_i}, rotated - acc,
                            signed gadget decomposition;
      external_product_crt  K2 (`pc_kernel` :1244): per prime, forward NTT
                            of the digits, product with the step's key
                            spectra, inverse NTT; then CRT back to the torus
                            and the add into the accumulator;
  "scan1" (K3, `fused_blind_rotate_scan1` :1281)
      pbs_step              a whole step in one launch: on Hopper the same
                            kernel as K4 (scan1w), whose step differs from
                            K3's on the TPU only in Mosaic's op
                            granularity;
  "scan1w" (K4, `fused_blind_rotate_scan1w` :965)
      pbs_step_single_cta   a whole step in one launch: K1's rotation and
                            decomposition inside K2's cluster of one CTA
                            per prime (or, for a batch that fills the card,
                            one CTA per ciphertext, the primes in turn);
  "scan3" (K6, `fused_blind_rotate_scan` :1470)
      rotate_decompose, then ntt_mac_prime once per prime (a pair of CTAs
      or one CTA per ciphertext), then crt_accumulate: 1 + P + 1 launches
      per step, the TPU's three-unit split;
  "grid" (K5, `fused_blind_rotate_grid` :1341)
      blind_rotate_persistent  all n steps in one launch: K4's cluster step
                            looped on chip, the accumulator resident (in
                            L2) and only the key slice streamed per step;
  "mega" (K7, `fused_blind_rotate_planes` :1545)
      blind_rotate_single_cta  all n steps in one launch on one CTA per
                            ciphertext (or, for a batch that leaves SMs
                            idle, a cluster of one CTA per prime), the
                            accumulator held on chip.

The kernels are CUDA C++ for sm_90a (`csrc/pbs_kernels.cuh` for K1 and
K6's `crt_accumulate`, `csrc/ntt_core_kernels.cuh` for K2, K3, K4, K5,
K6's `ntt_mac_prime` and K7), built by nvcc at first use into the
package's `_build/` directory and called through ctypes.  K2-K5,
`ntt_mac_prime` and K7 run on the register-resident NTT core of
`csrc/ntt_core.cuh`, with the per-pass twiddle tables of
`ntt.pass_tables_for`.  Each wrapper takes its plain PyTorch
version (`*_plain`) for CPU tensors, launches its kernel for CUDA tensors,
and raises for anything else: nothing falls back.  Each wrapper counts its
launches in its `launches` attribute.

The TPU's int8 limb planes and [R*ld, C*B] tiling are TPU scheduling; the
port's layouts are its own (see the header of `csrc/pbs_kernels.cuh`), and
the key spectra are prepared once by `prepare_bsk_cuda`, the counterpart of
`prepare_bsk_fused` (:1717).
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
from dataclasses import dataclass

import torch

from .._native import build_shared_library
from . import ntt
from .decomposition import signed_decompose
from .polymul import monomial_mul
from .torus import MASK32, lsr, wrap

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
BUILD_TIMEOUT_S = 120


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                        "nvcc")


# the register-resident core, the kernels on it (K2, K4, K6's
# ntt_mac_prime, K7) and their host launch code, which pbs_kernels.cu and
# single_cta_kernels.cu both include
_CORE_HEADERS = ("ntt_core.cuh", "ntt_core_kernels.cuh", "core_launch.cuh")


def _headers(*names: str) -> tuple[str, ...]:
    return tuple(os.path.join(_CSRC, n) for n in dict.fromkeys(names))


@functools.cache
def cuda_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the step kernels' shared
    library (K1, K2, K6).

    Raises `tfhe_tpu_torch._native.BuildError` with nvcc's stderr."""
    path = build_shared_library(
        "pbs_kernels", [os.path.join(_CSRC, "pbs_kernels.cu")],
        [_nvcc(), *NVCC_FLAGS], timeout=BUILD_TIMEOUT_S,
        headers=_headers("pbs_kernels.cuh", *_CORE_HEADERS))
    lib = ctypes.CDLL(path)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.tfhe_rotate_decompose.argtypes = [ptr, ptr, ptr] + [i32] * 6 + [ptr]
    lib.tfhe_external_product_crt.argtypes = [ptr] * 8 + [i32] * 7 + [ptr]
    lib.tfhe_ntt_mac_prime.argtypes = [ptr] * 5 + [i32] * 7 + [ptr]
    lib.tfhe_crt_accumulate.argtypes = [ptr] * 4 + [i32] * 6 + [ptr]
    for fn in (lib.tfhe_rotate_decompose, lib.tfhe_external_product_crt,
               lib.tfhe_ntt_mac_prime, lib.tfhe_crt_accumulate):
        fn.restype = i32
    return lib


@functools.cache
def single_cta_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the shared library of the
    kernels that hold a step's accumulator on chip (K3 and K4, K5, K7).
    Raises `tfhe_tpu_torch._native.BuildError`."""
    path = build_shared_library(
        "single_cta_kernels", [os.path.join(_CSRC, "single_cta_kernels.cu")],
        [_nvcc(), *NVCC_FLAGS], timeout=BUILD_TIMEOUT_S,
        headers=_headers("pbs_kernels.cuh", *_CORE_HEADERS))
    lib = ctypes.CDLL(path)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.tfhe_blind_rotate_single_cta,
               lib.tfhe_blind_rotate_persistent):
        fn.argtypes = [ptr] * 7 + [i32] * 9 + [ptr]
    lib.tfhe_pbs_step_single_cta.argtypes = [ptr] * 7 + [i32] * 8 + [ptr]
    lib.tfhe_blind_rotate_single_cta_form.argtypes = [i32] * 6 + [ptr]
    lib.tfhe_pbs_step_single_cta_form.argtypes = [i32] * 6 + [ptr]
    lib.tfhe_blind_rotate_persistent_clusters.argtypes = [i32] * 6 + [ptr]
    for fn in (lib.tfhe_blind_rotate_single_cta, lib.tfhe_pbs_step_single_cta,
               lib.tfhe_blind_rotate_persistent,
               lib.tfhe_blind_rotate_single_cta_form,
               lib.tfhe_pbs_step_single_cta_form,
               lib.tfhe_blind_rotate_persistent_clusters):
        fn.restype = i32
    return lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_aligned(name: str, t: torch.Tensor) -> None:
    """Kernels that read or write 16 bytes at a time take 16-byte aligned
    tensors."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


# digit polynomials (L*G) every kernel on the register-resident core takes
# (csrc/ntt_core_kernels.cuh kMaxDigitPolys); their C entry points refuse
# more
MAX_DIGIT_POLYS = 18


def _check_launch(err: int, name: str) -> None:
    """Raises RuntimeError unless the launch succeeded; a refused layout
    (cudaErrorInvalidValue) is named with the kernel's limits."""
    if err != 0:
        why = (f" (cudaErrorInvalidValue: a layout or shared-memory size "
               f"beyond the kernel's limits: at most {MAX_DIGIT_POLYS} digit "
               f"polynomials L*G, 256 <= N <= 2048 on the NTT core)"
               if err == 1 else "")
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}"
                           + why)


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ---------------------------------------------------------------------------
# K1: rotate + decompose
# ---------------------------------------------------------------------------


def rotate_decompose_plain(acc: torch.Tensor, ahat: torch.Tensor,
                           base_log: int, levels: int,
                           bits: int = 64) -> torch.Tensor:
    """acc [B, G, N] int64, ahat [B] int32 in [0, 2N] -> digits
    [B, L, G, N] int32 of signed_decompose(acc * X^ahat - acc)."""
    N = acc.shape[-1]
    rotated = monomial_mul(acc, ahat.unsqueeze(-1), N, bits=bits)
    digits = signed_decompose(wrap(rotated - acc, bits), base_log, levels,
                              bits=bits)  # [B, G, N, L]
    return digits.permute(0, 3, 1, 2).contiguous()


def rotate_decompose(acc: torch.Tensor, ahat: torch.Tensor, base_log: int,
                     levels: int, bits: int = 64) -> torch.Tensor:
    """K1 (replaces rot_kernel, tfhe_tpu/ops/fused_pbs.py:1229): a thread
    owns 4 consecutive coefficients of one (ciphertext, polynomial) row, so
    N >= 4, and reads its own as 16-byte loads, so acc is 16-byte
    aligned."""
    if acc.device.type == "cpu":
        return rotate_decompose_plain(acc, ahat, base_log, levels, bits)
    if acc.device.type != "cuda":
        raise ValueError(f"rotate_decompose: unsupported device {acc.device}")
    B, G, N = acc.shape
    _check("acc", acc, torch.int64, (B, G, N), acc.device)
    _check("ahat", ahat, torch.int32, (B,), acc.device)
    if N & (N - 1) or N < 4 or bits - base_log * levels < 1:
        raise ValueError("N must be a power of two of at least 4 and the "
                         "decomposition must leave at least one bit")
    _check_aligned("acc", acc)
    out = torch.empty((B, levels, G, N), dtype=torch.int32, device=acc.device)
    if B == 0:  # a grid of zero blocks is an invalid launch
        return out
    err = cuda_library().tfhe_rotate_decompose(
        acc.data_ptr(), ahat.data_ptr(), out.data_ptr(), B, G, N, base_log,
        levels, bits, _stream(acc.device))
    _check_launch(err, "rotate_decompose")
    rotate_decompose.launches += 1
    return out


rotate_decompose.launches = 0


# ---------------------------------------------------------------------------
# K2: external product through the NTT, CRT into the accumulator
# ---------------------------------------------------------------------------


def digit_spectra(digits: torch.Tensor) -> torch.Tensor:
    """digits [B, L, G, N] int32 -> [B, P, L*G, N] canonical spectra."""
    B, L, G, N = digits.shape
    dspec = ntt.forward_ntt(digits.reshape(B, L * G, N).to(torch.int64))
    return dspec.transpose(1, 2)


def spectral_mac(dspec: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """dspec [B, P, LJ, N], key [B or 1, P, LJ, O, M, N] (canonical
    residues) -> [B, P, O, M, N]: sum_lj dspec_lj * key_lj mod p."""
    P, N = key.shape[1], key.shape[-1]
    p = ntt.tables_for(N, dspec.device).primes.view(1, P, 1, 1, 1)
    prod = dspec[:, :, :, None, None, :] * key.to(torch.int64)
    return (prod % p.unsqueeze(-1)).sum(dim=2) % p


def residues_to_torus(res: torch.Tensor, bits: int = 64) -> torch.Tensor:
    """[B, O, M, P, N] canonical residues of the convolutions -> [B, O, N]
    int64: the CRT, and the M 32-bit planes joined into one torus word."""
    conv = ntt.crt_to_u64_centered(res.to(torch.int64))  # [B, O, M, N]
    out = conv[:, :, 0]
    if res.shape[2] == 2:
        out = out + (conv[:, :, 1] << 32)
    return wrap(out, bits)


def spectra_to_u64(spec: torch.Tensor, bits: int = 64) -> torch.Tensor:
    """[B, P, O, M, N] canonical spectra -> [B, O, N] int64: the inverse
    NTT, then `residues_to_torus`."""
    return residues_to_torus(ntt.inverse_ntt(spec.permute(0, 2, 3, 1, 4)),
                             bits)


def external_product_crt_plain(digits: torch.Tensor, kspec: torch.Tensor,
                               acc: torch.Tensor,
                               bits: int = 64) -> torch.Tensor:
    """digits [B, L, G, N] int32, kspec [P, LJ, O, M, N] (canonical residues),
    acc [B, O, N] int64 -> acc + sum_lj digits_lj (x) key_lj (mod 2^bits)."""
    spec = spectral_mac(digit_spectra(digits), kspec[None])
    return wrap(acc + spectra_to_u64(spec, bits), bits)


def external_product_crt(digits: torch.Tensor, kspec: torch.Tensor,
                         kshoup: torch.Tensor, acc: torch.Tensor,
                         bits: int = 64) -> torch.Tensor:
    """K2 (replaces pc_kernel, tfhe_tpu/ops/fused_pbs.py:1244).  Returns a
    new accumulator, from one launch of `external_product_cluster_kernel`:
    a cluster of one CTA per prime and ciphertext on the register-resident
    NTT core, the explicit CRT in the same launch.  The core takes
    256 <= N <= 2048 (`ntt.pass_tables_for` raises otherwise) and L*G <=
    MAX_DIGIT_POLYS (18) digit polynomials, in the 9-digit variant up to 9
    and an 18-digit one above (the launch is refused otherwise), as every
    kernel on the core."""
    if digits.device.type == "cpu":
        return external_product_crt_plain(digits, kspec, acc, bits)
    if digits.device.type != "cuda":
        raise ValueError(
            f"external_product_crt: unsupported device {digits.device}")
    dev = digits.device
    B, L, G, N = digits.shape
    P, LJ, O, M, _ = kspec.shape
    _check("digits", digits, torch.int32, (B, L, G, N), dev)
    _check("kspec", kspec, torch.int32, (P, L * G, G, M, N), dev)
    _check("kshoup", kshoup, torch.int32, (P, L * G, G, M, N), dev)
    _check("acc", acc, torch.int64, (B, G, N), dev)
    if P != len(ntt.PRIMES) or M != (2 if bits == 64 else 1):
        raise ValueError(f"key layout P={P}, M={M} does not match bits={bits}")
    twiddles = ntt.pass_tables_for(N, dev)
    tab = ntt.tables_for(N, dev)
    out = torch.empty_like(acc)
    if B == 0:  # a grid of zero blocks is an invalid launch
        return out
    err = cuda_library().tfhe_external_product_crt(
        digits.data_ptr(), kspec.data_ptr(), kshoup.data_ptr(),
        twiddles.data_ptr(), tab.xcrt.data_ptr(),
        acc.data_ptr(), None, out.data_ptr(), B, LJ, O, M, P, N, bits,
        _stream(dev))
    _check_launch(err, "external_product_crt")
    external_product_crt.launches += 1
    return out


external_product_crt.launches = 0


# ---------------------------------------------------------------------------
# K6: one prime's NTT-MAC-INTT, and the CRT, as launches of their own
# ---------------------------------------------------------------------------


def ntt_mac_prime_plain(digits: torch.Tensor, kspec_p: torch.Tensor,
                        prime_index: int,
                        residues: torch.Tensor) -> torch.Tensor:
    """digits [B, L, G, N] int32, kspec_p [LJ, O, M, N] (prime prime_index's
    canonical key spectra) -> writes that prime's residues of the O*M
    convolutions into residues [B, O, M, P, N] int32 and returns it.  Only
    that prime's transforms and products are computed."""
    B, L, G, N = digits.shape
    p = int(ntt.PRIMES[prime_index])
    dspec = ntt.forward_ntt(digits.reshape(B, L * G, N).to(torch.int64),
                            prime_index)[:, :, 0]  # [B, LJ, N]
    prod = dspec[:, :, None, None, :] * kspec_p.to(torch.int64)
    spec = (prod % p).sum(dim=1) % p  # [B, O, M, N]
    coef = ntt.inverse_ntt(spec[..., None, :], prime_index)  # [B, O, M, 1, N]
    residues[:, :, :, prime_index] = coef[:, :, :, 0].to(torch.int32)
    return residues


def ntt_mac_prime(digits: torch.Tensor, kspec_p: torch.Tensor,
                  kshoup_p: torch.Tensor, prime_index: int,
                  residues: torch.Tensor) -> torch.Tensor:
    """K6's per-prime stage (replaces prime_kernel -> _prime_block,
    tfhe_tpu/ops/fused_pbs.py:1503, :672): one launch of
    `ntt_mac_prime_kernel` on the register-resident NTT core, a cluster of
    two CTAs per ciphertext when the batch's pairs fit on the card at once,
    else one CTA per ciphertext.  Writes that prime's rows of residues in
    place (canonical) and returns it.  256 <= N <= 2048
    (`ntt.pass_tables_for` raises otherwise) and L*G <= 18, or the launch is
    refused."""
    if digits.device.type == "cpu":
        return ntt_mac_prime_plain(digits, kspec_p, prime_index, residues)
    if digits.device.type != "cuda":
        raise ValueError(f"ntt_mac_prime: unsupported device {digits.device}")
    dev = digits.device
    B, L, G, N = digits.shape
    LJ, O, M, _ = kspec_p.shape
    P = len(ntt.PRIMES)
    _check("digits", digits, torch.int32, (B, L, G, N), dev)
    _check("kspec_p", kspec_p, torch.int32, (L * G, G, M, N), dev)
    _check("kshoup_p", kshoup_p, torch.int32, (L * G, G, M, N), dev)
    _check("residues", residues, torch.int32, (B, G, M, P, N), dev)
    if not 0 <= prime_index < P or M not in (1, 2):
        raise ValueError(f"prime {prime_index} of {P}, M={M}")
    if B == 0:  # a grid of zero blocks is an invalid launch
        return residues
    err = cuda_library().tfhe_ntt_mac_prime(
        digits.data_ptr(), kspec_p.data_ptr(), kshoup_p.data_ptr(),
        ntt.pass_tables_for(N, dev).data_ptr(), residues.data_ptr(), B, LJ,
        O, M, P, N, prime_index, _stream(dev))
    _check_launch(err, "ntt_mac_prime")
    ntt_mac_prime.launches += 1
    return residues


ntt_mac_prime.launches = 0


def crt_accumulate_plain(residues: torch.Tensor, acc: torch.Tensor,
                         bits: int = 64) -> torch.Tensor:
    """residues [B, O, M, P, N] int32, acc [B, O, N] int64 ->
    acc + the reconstructed convolutions (mod 2^bits)."""
    return wrap(acc + residues_to_torus(residues, bits), bits)


def crt_accumulate(residues: torch.Tensor, acc: torch.Tensor,
                   bits: int = 64) -> torch.Tensor:
    """K6's last stage (replaces crt_kernel -> _crt_accumulate,
    tfhe_tpu/ops/fused_pbs.py:1520, :709): `crt_accumulate_kernel`, the
    explicit CRT on `ntt.residue_crt_for`, 4 coefficients a thread.
    Returns a new accumulator.  The residues are those of convolutions
    below 2^67 in magnitude, as `ntt_mac_prime` writes them (the explicit
    CRT's range, `ntt._explicit_crt_host`); residues and acc 16-byte
    aligned, N a power of two of at least 4."""
    if residues.device.type == "cpu":
        return crt_accumulate_plain(residues, acc, bits)
    if residues.device.type != "cuda":
        raise ValueError(
            f"crt_accumulate: unsupported device {residues.device}")
    dev = residues.device
    B, O, M, P, N = residues.shape
    _check("residues", residues, torch.int32, (B, O, M, len(ntt.PRIMES), N),
           dev)
    _check("acc", acc, torch.int64, (B, O, N), dev)
    if M != (2 if bits == 64 else 1):
        raise ValueError(f"{M} residue planes do not match bits={bits}")
    _check_aligned("residues", residues)
    _check_aligned("acc", acc)
    out = torch.empty_like(acc)
    if B == 0:  # a grid of zero blocks is an invalid launch
        return out
    err = cuda_library().tfhe_crt_accumulate(
        residues.data_ptr(), ntt.residue_crt_for(dev).data_ptr(),
        acc.data_ptr(), out.data_ptr(), B, O, M, P, N, bits, _stream(dev))
    _check_launch(err, "crt_accumulate")
    crt_accumulate.launches += 1
    return out


crt_accumulate.launches = 0


# ---------------------------------------------------------------------------
# K3 (a whole step) and K5 (a whole rotation)
# ---------------------------------------------------------------------------


def pbs_step_plain(acc: torch.Tensor, ahat: torch.Tensor, kspec: torch.Tensor,
                   base_log: int, levels: int,
                   bits: int = 64) -> torch.Tensor:
    """One blind-rotation step: acc + GGSW (x) (acc * X^ahat - acc), with
    acc [B, G, N] int64, ahat [B] int32, kspec [P, LJ, O, M, N]."""
    digits = rotate_decompose_plain(acc, ahat, base_log, levels, bits)
    return external_product_crt_plain(digits, kspec, acc, bits)


def blind_rotate_persistent_plain(acc: torch.Tensor, ahat: torch.Tensor,
                                  kspec: torch.Tensor, base_log: int,
                                  levels: int,
                                  bits: int = 64) -> torch.Tensor:
    """All steps: ahat [n, B], kspec [n, P, LJ, O, M, N]."""
    for i in range(ahat.shape[0]):
        acc = pbs_step_plain(acc, ahat[i], kspec[i], base_log, levels, bits)
    return acc


def _check_rotation(acc: torch.Tensor, ahat: torch.Tensor,
                    kspec: torch.Tensor, kshoup: torch.Tensor, base_log: int,
                    levels: int, bits: int) -> tuple:
    """Checks the inputs of a launch over ahat.shape[0] steps: acc [B, G, N]
    int64, ahat [n, B] int32, kspec / kshoup [n, P, LJ, O, M, N] int32.
    Returns (B, n, G, M, P, N)."""
    dev = acc.device
    B, G, N = acc.shape
    n = ahat.shape[0]
    P, M = len(ntt.PRIMES), (2 if bits == 64 else 1)
    _check("acc", acc, torch.int64, (B, G, N), dev)
    _check("ahat", ahat, torch.int32, (n, B), dev)
    for key_name, key in (("kspec", kspec), ("kshoup", kshoup)):
        _check(key_name, key, torch.int32, (n, P, levels * G, G, M, N), dev)
    if N & (N - 1) or bits - base_log * levels < 1:
        raise ValueError("N must be a power of two and the decomposition "
                         "must leave at least one bit")
    return B, n, G, M, P, N


def pbs_step(acc: torch.Tensor, ahat: torch.Tensor, kspec: torch.Tensor,
             kshoup: torch.Tensor, base_log: int, levels: int,
             bits: int = 64) -> torch.Tensor:
    """K3 (replaces step_kernel, tfhe_tpu/ops/fused_pbs.py:1304 ->
    `_step_math_onekernel` :809): one whole step in one launch, through K4's
    C entry point (`pbs_step_cluster_kernel`, or K7's
    `blind_rotate_core_kernel` over one step where the batch fills the card
    in fewer waves; `pbs_step_single_cta_form` says which).  On the TPU, K3
    and K4 (`_primes_crt_math_wide` :826) compute the same exact step and
    differ only in how Mosaic splits it into ops (:826-835), a TPU
    scheduling artefact; on Hopper they are one kernel.  Counted here, not
    in `pbs_step_single_cta.launches`.  acc [B, G, N], ahat [B], kspec /
    kshoup [P, LJ, O, M, N]; returns a new accumulator.  256 <= N <= 2048
    (`ntt.pass_tables_for` raises otherwise) and L*G <= 18, or the launch is
    refused."""
    return _step_on_core(pbs_step, acc, ahat, kspec, kshoup, base_log, levels,
                         bits)


pbs_step.launches = 0


def blind_rotate_persistent(acc: torch.Tensor, ahat: torch.Tensor,
                            kspec: torch.Tensor, kshoup: torch.Tensor,
                            base_log: int, levels: int,
                            bits: int = 64) -> torch.Tensor:
    """K5 (replaces _make_grid_kernel, tfhe_tpu/ops/fused_pbs.py:1020): all
    n steps in one launch of `blind_rotate_stream_cluster_kernel` on the
    register-resident NTT core, K4's cluster step looped on chip: a cluster
    of one CTA per prime and ciphertext at every B, the accumulator updated
    in place in the output (resident in L2) and only the step's key slice
    streamed (`blind_rotate_persistent_waves` says how many waves a batch
    takes).  256 <= N <= 2048 (a ValueError otherwise) and L*G <= 18, or
    the launch is refused.  ahat [n, B], kspec / kshoup [n, P, LJ, O, M, N];
    returns a new accumulator."""
    if acc.device.type == "cpu":
        return blind_rotate_persistent_plain(acc, ahat, kspec, base_log,
                                             levels, bits)
    if acc.device.type != "cuda":
        raise ValueError(
            f"blind_rotate_persistent: unsupported device {acc.device}")
    out = _launch_on_core("blind_rotate_persistent", acc, ahat, kspec,
                          kshoup, base_log, levels, bits,
                          whole_rotation=True)
    if acc.shape[0]:
        blind_rotate_persistent.launches += 1
    return out


blind_rotate_persistent.launches = 0


def _launch_on_core(name: str, acc: torch.Tensor, ahat: torch.Tensor,
                    kspec: torch.Tensor, kshoup: torch.Tensor, base_log: int,
                    levels: int, bits: int, whole_rotation: bool,
                    caller: str | None = None) -> torch.Tensor:
    """Checks, then one launch through the C entry point tfhe_<name> of
    single_cta_kernels.cu over ahat.shape[0] steps (one step unless
    whole_rotation); ahat [n, B], kspec / kshoup [n, P, LJ, O, M, N].  An N
    outside the core's 256 ... 2048 raises ValueError, a refused launch
    RuntimeError, both under `caller` (default: name)."""
    B, n, G, M, P, N = _check_rotation(acc, ahat, kspec, kshoup, base_log,
                                       levels, bits)
    if not 256 <= N <= 2048:
        raise ValueError(f"{caller or name}: N = {N} is outside the NTT "
                         f"core's 256 ... 2048")
    out = torch.empty_like(acc)
    if B == 0:  # a grid of zero blocks is an invalid launch
        return out
    steps = (n,) if whole_rotation else ()
    tables = ntt.pass_tables_for(N, acc.device)
    err = getattr(single_cta_library(), f"tfhe_{name}")(
        acc.data_ptr(), ahat.data_ptr(), kspec.data_ptr(), kshoup.data_ptr(),
        tables.data_ptr(), ntt.tables_for(N, acc.device).xcrt.data_ptr(),
        out.data_ptr(), B, *steps, G, M, P, N, base_log, levels, bits,
        _stream(acc.device))
    _check_launch(err, caller or name)
    return out


def _step_on_core(wrapper, acc: torch.Tensor, ahat: torch.Tensor,
                  kspec: torch.Tensor, kshoup: torch.Tensor, base_log: int,
                  levels: int, bits: int) -> torch.Tensor:
    """The body of K3 and K4, one kernel on Hopper: one whole step through
    the C entry point tfhe_pbs_step_single_cta, counted in
    `wrapper.launches` and reported under the wrapper's name; the plain
    version on a CPU tensor."""
    name = wrapper.__name__
    if acc.device.type == "cpu":
        return pbs_step_plain(acc, ahat, kspec, base_log, levels, bits)
    if acc.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {acc.device}")
    out = _launch_on_core("pbs_step_single_cta", acc, ahat[None],
                          kspec[None], kshoup[None], base_log, levels, bits,
                          whole_rotation=False, caller=name)
    if acc.shape[0]:
        wrapper.launches += 1
    return out


# ---------------------------------------------------------------------------
# K4: a whole step in one launch, on the register-resident core
# ---------------------------------------------------------------------------


def pbs_step_single_cta(acc: torch.Tensor, ahat: torch.Tensor,
                        kspec: torch.Tensor, kshoup: torch.Tensor,
                        base_log: int, levels: int,
                        bits: int = 64) -> torch.Tensor:
    """K4 (replaces step_kernel, tfhe_tpu/ops/fused_pbs.py:983): one whole
    step in one launch on the register-resident NTT core:
    `pbs_step_cluster_kernel` (a cluster of one CTA per prime and
    ciphertext, the digits made inside and shared over the cluster, the
    explicit CRT in the same launch) or, when the batch fills the card in
    fewer waves that way, K7's `blind_rotate_core_kernel` over one step
    (one CTA per ciphertext); the C entry point picks one from B and the
    device's occupancy (`pbs_step_single_cta_form` says which).  acc
    [B, G, N], ahat [B], kspec / kshoup [P, LJ, O, M, N]; returns a new
    accumulator.  256 <= N <= 2048 (`ntt.pass_tables_for` raises otherwise)
    and L*G <= 18, or the launch is refused.  Its plain version is
    `pbs_step_plain`."""
    return _step_on_core(pbs_step_single_cta, acc, ahat, kspec, kshoup,
                         base_log, levels, bits)


pbs_step_single_cta.launches = 0

# ---------------------------------------------------------------------------
# K7: all steps in one launch, the accumulator held on chip
# ---------------------------------------------------------------------------


def blind_rotate_single_cta(acc: torch.Tensor, ahat: torch.Tensor,
                            kspec: torch.Tensor, kshoup: torch.Tensor,
                            base_log: int, levels: int,
                            bits: int = 64) -> torch.Tensor:
    """K7 (replaces _make_kernel, tfhe_tpu/ops/fused_pbs.py:1403): all n
    steps in one launch on the register-resident NTT core, the accumulator
    held in shared memory throughout: `blind_rotate_core_kernel` (one CTA
    per ciphertext, the primes in turn) or, when the batch would leave SMs
    idle, `blind_rotate_cluster_core_kernel` (a cluster of one CTA per
    prime); the C entry point picks one from B and the device's SM count
    (`blind_rotate_single_cta_form` says which).  256 <= N <= 2048
    (`ntt.pass_tables_for` raises otherwise) and L*G <= 18, or the launch
    is refused.  ahat [n, B],
    kspec / kshoup [n, P, LJ, O, M, N]; returns a new accumulator.  Its
    plain version is `blind_rotate_persistent_plain`."""
    if acc.device.type == "cpu":
        return blind_rotate_persistent_plain(acc, ahat, kspec, base_log,
                                             levels, bits)
    if acc.device.type != "cuda":
        raise ValueError(f"blind_rotate_single_cta: unsupported device "
                         f"{acc.device}")
    out = _launch_on_core("blind_rotate_single_cta", acc, ahat, kspec,
                          kshoup, base_log, levels, bits,
                          whole_rotation=True)
    if acc.shape[0]:
        blind_rotate_single_cta.launches += 1
    return out


blind_rotate_single_cta.launches = 0


def _form(entry, name: str, B: int, N: int, G: int, levels: int, bits: int,
          kernels: tuple[str, str]) -> str:
    """kernels[1] if the C entry point `entry` says a batch of B runs as
    clusters, else kernels[0].  Launches nothing."""
    cluster = ctypes.c_int(0)
    err = entry(B, G, 2 if bits == 64 else 1, len(ntt.PRIMES), N, levels,
                ctypes.byref(cluster))
    _check_launch(err, name)
    return kernels[cluster.value]


def blind_rotate_single_cta_form(B: int, N: int, G: int, levels: int,
                                 bits: int = 64) -> str:
    """The kernel that `blind_rotate_single_cta` launches for a batch of B
    on the current card: "blind_rotate_core_kernel" or
    "blind_rotate_cluster_core_kernel".  Launches nothing."""
    return _form(single_cta_library().tfhe_blind_rotate_single_cta_form,
                 "blind_rotate_single_cta_form", B, N, G, levels, bits,
                 ("blind_rotate_core_kernel",
                  "blind_rotate_cluster_core_kernel"))


def blind_rotate_persistent_waves(B: int, N: int, G: int, levels: int,
                                  bits: int = 64) -> dict:
    """How `blind_rotate_persistent` runs a batch of B on the current card:
    the clusters the card holds at once (cudaOccupancyMaxActiveClusters)
    and the waves of whole rotations, ceil(B / clusters).  Launches
    nothing."""
    clusters = ctypes.c_int(0)
    err = single_cta_library().tfhe_blind_rotate_persistent_clusters(
        B, G, 2 if bits == 64 else 1, len(ntt.PRIMES), N, levels,
        ctypes.byref(clusters))
    _check_launch(err, "blind_rotate_persistent_waves")
    if clusters.value < 1:
        raise RuntimeError(f"blind_rotate_persistent_waves: the card holds "
                           f"{clusters.value} clusters")
    return {"clusters": clusters.value,
            "waves": -(-B // clusters.value)}


def pbs_step_single_cta_form(B: int, N: int, G: int, levels: int,
                             bits: int = 64) -> str:
    """The kernel that `pbs_step_single_cta` launches for a batch of B on
    the current card: "pbs_step_cluster_kernel" or
    "blind_rotate_core_kernel" (over one step).  Launches nothing."""
    return _form(single_cta_library().tfhe_pbs_step_single_cta_form,
                 "pbs_step_single_cta_form", B, N, G, levels, bits,
                 ("blind_rotate_core_kernel", "pbs_step_cluster_kernel"))

KERNELS = (rotate_decompose, external_product_crt, pbs_step,
           blind_rotate_persistent, ntt_mac_prime, crt_accumulate,
           pbs_step_single_cta, blind_rotate_single_cta)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


# ---------------------------------------------------------------------------
# prepared key and the blind-rotation loop
# ---------------------------------------------------------------------------


@dataclass
class PreparedBskCuda:
    """BSK as NTT spectra in the kernels' layout: kspec / kshoup
    [n, P, L*G, G, M, N] int32 (bit patterns of uint32 residues and their
    Shoup companions)."""

    kspec: torch.Tensor
    kshoup: torch.Tensor
    base_log: int
    levels: int
    glwe_size: int
    polynomial_size: int
    input_dim: int
    bits: int = 64


def _u32_bits(v: torch.Tensor) -> torch.Tensor:
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


# steps transformed at once by bsk_spectra and prepare_bsk_cuda: bounds their
# int64 temporaries (about 40 MB per 64 steps at N = 2048)
_PREPARE_CHUNK = 64


def bsk_spectra(raw_bsk: torch.Tensor, bits: int = 64) -> torch.Tensor:
    """Standard-domain BSK [n, L, G (row), G (poly), N] int64 -> the
    spectra of its 32-bit planes, [n, P, L*G, G, M, N] int32 canonical
    residues, computed on the key's device in chunks of steps."""
    n, L, J, O, N = raw_bsk.shape
    P = len(ntt.PRIMES)
    M = 2 if bits == 64 else 1
    kspec = torch.empty((n, P, L * J, O, M, N), dtype=torch.int32,
                        device=raw_bsk.device)
    for s in range(0, n, _PREPARE_CHUNK):
        x = raw_bsk[s:s + _PREPARE_CHUNK]
        if bits == 64:
            planes = torch.stack([x & MASK32, lsr(x, 32)], dim=-2)
        else:
            planes = x.unsqueeze(-2)  # [c, L, J, O, 1, N]
        spec = ntt.forward_ntt(planes)  # [c, L, J, O, M, P, N]
        spec = spec.permute(0, 5, 1, 2, 3, 4, 6).reshape(-1, P, L * J, O, M, N)
        kspec[s:s + _PREPARE_CHUNK] = spec.to(torch.int32)
    return kspec


def prepare_bsk_cuda(raw_bsk: torch.Tensor, base_log: int,
                     bits: int = 64) -> PreparedBskCuda:
    """Standard-domain BSK [n, L, G (row), G (poly), N] int64 -> spectra of
    its 32-bit planes and their Shoup companions, computed on the key's
    device (counterpart of prepare_bsk_fused,
    tfhe_tpu/ops/fused_pbs.py:1717)."""
    n, L, J, O, N = raw_bsk.shape
    P = len(ntt.PRIMES)
    p = ntt.tables_for(N, raw_bsk.device).primes.view(1, P, 1, 1, 1, 1)
    kspec = bsk_spectra(raw_bsk, bits)
    kshoup = torch.empty_like(kspec)
    for s in range(0, n, _PREPARE_CHUNK):
        spec = kspec[s:s + _PREPARE_CHUNK].to(torch.int64)  # below 2^17
        kshoup[s:s + _PREPARE_CHUNK] = _u32_bits((spec << 32) // p)
    return PreparedBskCuda(kspec=kspec, kshoup=kshoup, base_log=base_log,
                           levels=L, glwe_size=J, polynomial_size=N,
                           input_dim=n, bits=bits)


MODES = ("scan2", "scan1", "scan1w", "scan3", "grid", "mega")


def check_mode(mode: str) -> None:
    """Raises unless `mode` is one of `MODES`."""
    if mode not in MODES:
        raise ValueError(f"unknown blind-rotation mode {mode!r}; expected one "
                         f"of {MODES}")


def blind_rotate_fused(bsk: PreparedBskCuda, acc: torch.Tensor,
                       ahat: torch.Tensor, mode: str = "scan2") -> torch.Tensor:
    """The step loop of `_blind_rotate_fused_chunk` (tfhe_tpu/ops/
    fused_pbs.py:1730) in one of `MODES`: acc [B, G, N] int64 (already
    rotated by X^-b), ahat [n, B] int32 modulus-switched mask in [0, 2N]
    (2N rotates as 0 in every mode) -> rotated accumulator.  Every mode
    gives the same words."""
    check_mode(mode)
    acc = acc.contiguous()
    shape = (bsk.base_log, bsk.levels, bsk.bits)
    if mode == "grid":
        return blind_rotate_persistent(acc, ahat, bsk.kspec, bsk.kshoup,
                                       *shape)
    if mode == "mega":
        return blind_rotate_single_cta(acc, ahat, bsk.kspec, bsk.kshoup,
                                       *shape)
    if mode == "scan3":
        B, G, N = acc.shape
        P, M = bsk.kspec.shape[1], bsk.kspec.shape[-2]
        residues = torch.empty((B, G, M, P, N), dtype=torch.int32,
                               device=acc.device)
    for i in range(bsk.input_dim):
        ks, ksh = bsk.kspec[i], bsk.kshoup[i]
        if mode == "scan1":
            acc = pbs_step(acc, ahat[i], ks, ksh, *shape)
            continue
        if mode == "scan1w":
            acc = pbs_step_single_cta(acc, ahat[i], ks, ksh, *shape)
            continue
        digits = rotate_decompose(acc, ahat[i], *shape)
        if mode == "scan2":
            acc = external_product_crt(digits, ks, ksh, acc, bsk.bits)
            continue
        for pi in range(P):
            ntt_mac_prime(digits, ks[pi], ksh[pi], pi, residues)
        acc = crt_accumulate(residues, acc, bsk.bits)
    return acc
