"""Torus words as torch.int64 tensors.

torch has no arithmetic on uint64, so a u64 torus word travels as the int64
with the same bits: add, sub, mul and left shift wrap mod 2^64 exactly as the
unsigned operations do.  Right shift on int64 is arithmetic, so `lsr` masks
off the copied sign bits.  A u32 torus word travels as an int64 in
[0, 2^32) and `wrap` reduces it after each operation.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF


def wrap(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Reduce an int64 result to the torus width (identity at 64 bits)."""
    return x if bits == 64 else x & MASK32


def lsr(x: torch.Tensor, k: int, bits: int = 64) -> torch.Tensor:
    """Logical right shift of torus words by a static k."""
    if k == 0 or bits == 32:
        return x >> k
    return (x >> k) & ((1 << (64 - k)) - 1)


def to_tensor(arr, device) -> torch.Tensor:
    """uint64 / uint32 numpy torus words -> int64 tensor on `device`."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.uint64:
        arr = arr.view(np.int64)
    elif arr.dtype in (np.uint32, np.uint8):
        arr = arr.astype(np.int64)
    elif arr.dtype != np.int64:
        raise TypeError(f"torus words must be uint64/uint32, got {arr.dtype}")
    return torch.from_numpy(arr.copy()).to(device)


def to_numpy(t: torch.Tensor, bits: int = 64) -> np.ndarray:
    """int64 torus tensor -> uint64 (or uint32) numpy array on the host."""
    arr = t.detach().to("cpu").contiguous().numpy()
    if bits == 64:
        return arr.view(np.uint64)
    return arr.astype(np.uint32)
