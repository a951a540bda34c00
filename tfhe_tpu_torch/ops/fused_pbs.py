"""Blind rotation on two hand-written CUDA kernels, and their plain versions.

Port of `tfhe_tpu/ops/fused_pbs.py`: `fused_blind_rotate_scan2` (:1213), the
default TPU schedule, launches two Pallas kernels per blind-rotation step,
`rot_kernel` (:1229) and `pc_kernel` (:1244).  Their counterparts here:

  rotate_decompose      K1: negacyclic rotation of the accumulator by
                        X^{a_i}, rotated - acc, signed gadget decomposition;
  external_product_crt  K2: per prime, forward NTT of the digits, product
                        with the step's key spectra, inverse NTT; then CRT
                        back to u64 and the add into the accumulator.

Both are CUDA C++ for sm_90a (`csrc/pbs_kernels.cuh`), built by nvcc at first
use into the package's `_build/` directory and called through ctypes.  Each
wrapper takes its plain PyTorch version (`*_plain`) for CPU tensors, launches
the kernel for CUDA tensors, and raises for anything else: nothing falls back.
Each wrapper counts its launches in its `launches` attribute.

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


@functools.cache
def cuda_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernels' shared library.

    Raises `tfhe_tpu_torch._native.BuildError` with nvcc's stderr."""
    path = build_shared_library(
        "pbs_kernels", [os.path.join(_CSRC, "pbs_kernels.cu")],
        [_nvcc(), *NVCC_FLAGS], timeout=BUILD_TIMEOUT_S,
        headers=(os.path.join(_CSRC, "pbs_kernels.cuh"),))
    lib = ctypes.CDLL(path)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.tfhe_rotate_decompose.argtypes = [ptr, ptr, ptr] + [i32] * 6 + [ptr]
    lib.tfhe_rotate_decompose.restype = i32
    lib.tfhe_external_product_crt.argtypes = [ptr] * 8 + [i32] * 7 + [ptr]
    lib.tfhe_external_product_crt.restype = i32
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


def _check_launch(err: int, name: str) -> None:
    if err != 0:
        why = (" (cudaErrorInvalidValue: a layout or shared-memory size "
               "beyond the kernel's limits)" if err == 1 else "")
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
    """K1 (replaces rot_kernel, tfhe_tpu/ops/fused_pbs.py:1229)."""
    if acc.device.type == "cpu":
        return rotate_decompose_plain(acc, ahat, base_log, levels, bits)
    if acc.device.type != "cuda":
        raise ValueError(f"rotate_decompose: unsupported device {acc.device}")
    B, G, N = acc.shape
    _check("acc", acc, torch.int64, (B, G, N), acc.device)
    _check("ahat", ahat, torch.int32, (B,), acc.device)
    if N & (N - 1) or bits - base_log * levels < 1:
        raise ValueError("N must be a power of two and the decomposition "
                         "must leave at least one bit")
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


def spectra_to_u64(spec: torch.Tensor, bits: int = 64) -> torch.Tensor:
    """[B, P, O, M, N] canonical spectra -> [B, O, N] int64: the inverse
    NTT, the CRT, and the M 32-bit planes joined into one torus word."""
    coef = ntt.inverse_ntt(spec.permute(0, 2, 3, 1, 4))  # [B, O, M, P, N]
    conv = ntt.crt_to_u64_centered(coef)  # [B, O, M, N]
    out = conv[:, :, 0]
    if spec.shape[3] == 2:
        out = out + (conv[:, :, 1] << 32)
    return wrap(out, bits)


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
    new accumulator; the two CUDA kernels (ntt_mac, crt_accumulate) run
    back to back on one stream and count as one launch."""
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
    if (L * G + G * M) * N * 4 > 227 * 1024:
        raise ValueError("digit and output spectra exceed shared memory")
    tab = ntt.tables_for(N, dev)
    residues = torch.empty((B, O, M, P, N), dtype=torch.int32, device=dev)
    out = torch.empty_like(acc)
    if B == 0:  # a grid of zero blocks is an invalid launch
        return out
    err = cuda_library().tfhe_external_product_crt(
        digits.data_ptr(), kspec.data_ptr(), kshoup.data_ptr(),
        tab.kernel.data_ptr(), tab.crt.data_ptr(), acc.data_ptr(),
        residues.data_ptr(), out.data_ptr(), B, LJ, O, M, P, N, bits,
        _stream(dev))
    _check_launch(err, "external_product_crt")
    external_product_crt.launches += 1
    return out


external_product_crt.launches = 0

KERNELS = (rotate_decompose, external_product_crt)


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


# steps transformed at once by prepare_bsk_cuda: bounds its int64 temporaries
# (about 40 MB per 64 steps at N = 2048)
_PREPARE_CHUNK = 64


def prepare_bsk_cuda(raw_bsk: torch.Tensor, base_log: int,
                     bits: int = 64) -> PreparedBskCuda:
    """Standard-domain BSK [n, L, G (row), G (poly), N] int64 -> spectra of
    its 32-bit planes, computed on the key's device (counterpart of
    prepare_bsk_fused, tfhe_tpu/ops/fused_pbs.py:1717)."""
    n, L, J, O, N = raw_bsk.shape
    P = len(ntt.PRIMES)
    p = ntt.tables_for(N, raw_bsk.device).primes.view(1, P, 1, 1, 1, 1)
    M = 2 if bits == 64 else 1
    kspec = torch.empty((n, P, L * J, O, M, N), dtype=torch.int32,
                        device=raw_bsk.device)
    kshoup = torch.empty_like(kspec)
    for s in range(0, n, _PREPARE_CHUNK):
        x = raw_bsk[s:s + _PREPARE_CHUNK]
        if bits == 64:
            planes = torch.stack([x & MASK32, lsr(x, 32)], dim=-2)
        else:
            planes = x.unsqueeze(-2)  # [c, L, J, O, 1, N]
        spec = ntt.forward_ntt(planes)  # [c, L, J, O, M, P, N]
        spec = spec.permute(0, 5, 1, 2, 3, 4, 6).reshape(-1, P, L * J, O, M, N)
        kspec[s:s + _PREPARE_CHUNK] = spec.to(torch.int32)
        kshoup[s:s + _PREPARE_CHUNK] = _u32_bits((spec << 32) // p)
    return PreparedBskCuda(kspec=kspec, kshoup=kshoup, base_log=base_log,
                           levels=L, glwe_size=J, polynomial_size=N,
                           input_dim=n, bits=bits)


def blind_rotate_fused(bsk: PreparedBskCuda, acc: torch.Tensor,
                       ahat: torch.Tensor) -> torch.Tensor:
    """The step loop of `_blind_rotate_fused_chunk` (tfhe_tpu/ops/
    fused_pbs.py:1730): acc [B, G, N] int64 (already rotated by X^-b),
    ahat [n, B] int32 modulus-switched mask -> rotated accumulator."""
    acc = acc.contiguous()
    for i in range(bsk.input_dim):
        digits = rotate_decompose(acc, ahat[i], bsk.base_log, bsk.levels,
                                  bsk.bits)
        acc = external_product_crt(digits, bsk.kspec[i], bsk.kshoup[i], acc,
                                   bsk.bits)
    return acc
