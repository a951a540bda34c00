"""The Shoup spectrum multiply-accumulate of one prime, on a hand-written
CUDA kernel, and its plain version.

Port of `tfhe_tpu/ops/pallas_kernels.py` (K10: `shoup_mac` :64 ->
`_shoup_mac_kernel` :39), the middle stage of the CRT-NTT external product
(`ops/polymul_ntt.py`).  The reference switches its Pallas kernel on with
TFHE_TPU_PALLAS=1 and otherwise runs the same arithmetic as jnp ops; here
the stage always runs the kernel for CUDA tensors, and its plain PyTorch
version `shoup_mac_plain` for CPU tensors only.  The kernel is CUDA C++
for sm_90a (`csrc/shoup_mac_kernels.cuh`), built by nvcc at first use into
the package's `_build/` directory and called through ctypes; the wrapper
counts its launches in its `launches` attribute.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from .._native import build_shared_library
from .fused_pbs import (_CSRC, BUILD_TIMEOUT_S, NVCC_FLAGS, _check,
                        _check_launch, _nvcc, _stream)

SHOUP_BITS = 16
# the kernel's centring rounds a float quotient |acc / p| <= LJ / 2; below
# 8 its error stays far from a half (csrc/shoup_mac_kernels.cuh)
MAX_LJ = 15


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
    lib.tfhe_shoup_mac.argtypes = [ptr] * 4 + [ctypes.c_longlong] + [i32] * 4 \
        + [ptr]
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
    if not 0 < LJ <= MAX_LJ or not 2 < p < 1 << 17 or p % 2 == 0:
        raise ValueError(f"shoup_mac: LJ = {LJ} (at most {MAX_LJ}) and "
                         f"p = {p} (an odd prime below 2^17)")
    if dev.type == "cpu":
        return shoup_mac_plain(a, ks, ksh, p)
    out = torch.empty((B, GM, N), dtype=torch.int32, device=dev)
    if out.numel() == 0:  # a grid of zero blocks is an invalid launch
        return out
    err = cuda_library().tfhe_shoup_mac(
        a.data_ptr(), ks.data_ptr(), ksh.data_ptr(), out.data_ptr(), B, LJ,
        GM, N, p, _stream(dev))
    _check_launch(err, "shoup_mac")
    shoup_mac.launches += 1
    return out


shoup_mac.launches = 0

KERNELS = (shoup_mac,)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
