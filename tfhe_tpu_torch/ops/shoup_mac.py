"""The Shoup spectrum multiply-accumulate, on a hand-written CUDA kernel,
and its plain versions.

Port of `tfhe_tpu/ops/pallas_kernels.py` (K10: `shoup_mac` :64 ->
`_shoup_mac_kernel` :39), the middle stage of the CRT-NTT external product
(`ops/polymul_ntt.py`).  The reference switches its Pallas kernel on with
TFHE_TPU_PALLAS=1 and otherwise runs the same arithmetic as jnp ops; here
the stage always runs the kernel for CUDA tensors, and its plain PyTorch
version for CPU tensors only.  Two wrappers launch the one kernel
(`csrc/shoup_mac_kernels.cuh`, CUDA C++ for sm_90a, built by nvcc at first
use into the package's `_build/` directory and called through ctypes):
`shoup_mac`, one prime, the reference's call; and `shoup_mac_primes`, all
the primes of a step in one launch, written in the layout the inverse NTT
reads, which the CRT-NTT path runs.  Each counts its launches in its
`launches` attribute (a counter of `utils.profiling`).
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from .._native import build_shared_library
from ..utils import profiling
from .fused_pbs import (_CSRC, BUILD_TIMEOUT_S, NVCC_FLAGS, _check,
                        _check_launch, _nvcc, _stream)

SHOUP_BITS = 16
# the kernel's centring rounds a float quotient |acc / p| <= LJ / 2; below
# 8 its error stays far from a half (csrc/shoup_mac_kernels.cuh)
MAX_LJ = 15
MAX_PRIMES = 8  # the kernel takes the primes by value (kMaxPrimes)


@functools.cache
def cuda_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the Shoup MAC's shared library
    (K10).  Raises `tfhe_tpu_torch._native.BuildError` with nvcc's stderr."""
    path = build_shared_library(
        "shoup_mac_kernels", [os.path.join(_CSRC, "shoup_mac_kernels.cu")],
        [_nvcc(), *NVCC_FLAGS], timeout=BUILD_TIMEOUT_S,
        headers=(os.path.join(_CSRC, "shoup_mac_kernels.cuh"),))
    lib = ctypes.CDLL(path)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.tfhe_shoup_mac.argtypes = [ptr] * 5 + [i32] * 5 + [ptr]
    lib.tfhe_shoup_mac.restype = i32
    return lib


def shoup_mac_plain(a: torch.Tensor, ks: torch.Tensor, ksh: torch.Tensor,
                    p: int) -> torch.Tensor:
    """a [B, LJ, N], ks / ksh [LJ, GM, N] balanced int32 -> [B, GM, N]
    balanced int32: sum_j a[:, j] * ks[j] mod p, in the Pallas body's int32
    arithmetic (tfhe_tpu/ops/pallas_kernels.py:45-60)."""
    half = p // 2
    a_ = a[:, :, None, :]  # [B, LJ, 1, N]
    q = (a_ * ksh) >> SHOUP_BITS
    r = a_ * ks - q * p
    r = torch.where(r > half, r - p, r)
    r = torch.where(r > half, r - p, r)
    r = torch.where(r < -half, r + p, r)
    r = torch.where(r < -half, r + p, r)
    acc = r.sum(dim=1, dtype=torch.int32)
    return acc - torch.round(acc.to(torch.float32) / p).to(torch.int32) * p


def _check_prime(name: str, LJ: int, p: int) -> None:
    if not 0 < LJ <= MAX_LJ or not 2 < p < 1 << 17 or p % 2 == 0:
        raise ValueError(f"{name}: LJ = {LJ} (at most {MAX_LJ}) and "
                         f"p = {p} (an odd prime below 2^17)")


def _launch(name: str, a: torch.Tensor, ks: torch.Tensor, ksh: torch.Tensor,
            out: torch.Tensor, primes: tuple[int, ...], B: int, LJ: int,
            GM: int, N: int) -> None:
    """One launch over len(primes) primes: a [P, B, LJ, N], ks / ksh
    [P, LJ, GM, N] -> out [B, GM, P, N] (contiguous, on one card)."""
    if N % 4 or any(t.data_ptr() % 16 for t in (a, ks, ksh, out)):
        raise ValueError(f"{name}: the kernel reads 16-byte vectors: N = {N} "
                         f"must be a multiple of 4 and every tensor 16-byte "
                         f"aligned")
    if B >= 1 << 31:
        raise ValueError(f"{name}: a batch of {B} is beyond the kernel's int "
                         f"index")
    ps = (ctypes.c_int * len(primes))(*primes)
    err = cuda_library().tfhe_shoup_mac(
        a.data_ptr(), ks.data_ptr(), ksh.data_ptr(), out.data_ptr(), ps,
        len(primes), B, LJ, GM, N, _stream(a.device))
    _check_launch(err, name)


def shoup_mac(a: torch.Tensor, ks: torch.Tensor, ksh: torch.Tensor,
              p: int) -> torch.Tensor:
    """K10 (replaces `shoup_mac`, tfhe_tpu/ops/pallas_kernels.py:64):
    a [B, LJ, N], ks / ksh [LJ, GM, N] balanced int32 -> [B, GM, N].  The
    inputs are checked on every device; CPU tensors take the plain
    version, CUDA tensors the kernel."""
    dev = a.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"shoup_mac: unsupported device {dev}")
    if a.dim() != 3 or ks.dim() != 3:
        raise ValueError(f"shoup_mac: a and ks must be 3-d, got "
                         f"{tuple(a.shape)} and {tuple(ks.shape)}")
    B, LJ, N = a.shape
    GM = ks.shape[1]
    _check("a", a, torch.int32, (B, LJ, N), dev)
    _check("ks", ks, torch.int32, (LJ, GM, N), dev)
    _check("ksh", ksh, torch.int32, (LJ, GM, N), dev)
    _check_prime("shoup_mac", LJ, p)
    if dev.type == "cpu":
        return shoup_mac_plain(a, ks, ksh, p)
    out = torch.empty((B, GM, N), dtype=torch.int32, device=dev)
    if out.numel() == 0:  # a grid of zero blocks is an invalid launch
        return out
    # the all-primes kernel with one prime: out [B, GM, 1, N] is [B, GM, N]
    _launch("shoup_mac", a, ks, ksh, out, (p,), B, LJ, GM, N)
    shoup_mac.launches += 1
    return out


shoup_mac.launches = 0


def shoup_mac_primes_plain(a: torch.Tensor, ks: torch.Tensor,
                           ksh: torch.Tensor,
                           primes: tuple[int, ...]) -> torch.Tensor:
    """a [P, B, LJ, N], ks / ksh [P, LJ, GM, N] balanced int32 ->
    [B, GM, P, N]: `shoup_mac_plain` of each prime, stacked in the layout
    the inverse NTT reads."""
    return torch.stack([shoup_mac_plain(a[i], ks[i], ksh[i], int(p))
                        for i, p in enumerate(primes)], dim=2)


def shoup_mac_primes(a: torch.Tensor, ks: torch.Tensor, ksh: torch.Tensor,
                     primes: tuple[int, ...]) -> torch.Tensor:
    """K10 over all the primes of a step in one launch (the reference calls
    `shoup_mac`, tfhe_tpu/ops/pallas_kernels.py:64, once per prime):
    a [P, B, LJ, N], ks / ksh [P, LJ, GM, N] balanced int32 -> [B, GM, P, N]
    balanced int32, prime i's sums at [:, :, i].  The inputs are checked on
    every device; CPU tensors take `shoup_mac_primes_plain`, CUDA tensors
    the kernel."""
    dev = a.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"shoup_mac_primes: unsupported device {dev}")
    if a.dim() != 4 or ks.dim() != 4:
        raise ValueError(f"shoup_mac_primes: a and ks must be 4-d, got "
                         f"{tuple(a.shape)} and {tuple(ks.shape)}")
    P, B, LJ, N = a.shape
    GM = ks.shape[2]
    primes = tuple(int(p) for p in primes)
    if len(primes) != P or not 0 < P <= MAX_PRIMES:
        raise ValueError(f"shoup_mac_primes: {len(primes)} primes for {P} "
                         f"digit blocks (at most {MAX_PRIMES})")
    _check("a", a, torch.int32, (P, B, LJ, N), dev)
    _check("ks", ks, torch.int32, (P, LJ, GM, N), dev)
    _check("ksh", ksh, torch.int32, (P, LJ, GM, N), dev)
    for p in primes:
        _check_prime("shoup_mac_primes", LJ, p)
    if dev.type == "cpu":
        return shoup_mac_primes_plain(a, ks, ksh, primes)
    out = torch.empty((B, GM, P, N), dtype=torch.int32, device=dev)
    if out.numel() == 0:  # a grid of zero blocks is an invalid launch
        return out
    _launch("shoup_mac_primes", a, ks, ksh, out, primes, B, LJ, GM, N)
    shoup_mac_primes.launches += 1
    return out


shoup_mac_primes.launches = 0

KERNELS = (shoup_mac, shoup_mac_primes)
profiling.register_launches("shoup_mac", KERNELS)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
