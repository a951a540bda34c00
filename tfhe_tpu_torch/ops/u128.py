"""u128 torus words as int64 (lo, hi) pairs.

Port of `tfhe_tpu/ops/u128.py` (ref: tfhe/src/core_crypto/fft_impl/
fft128_u128/).  torch has no 128-bit integer, and no unsigned 64-bit
arithmetic either, so a u128 word rides on a trailing axis of two int64
words holding the bits of its low and high halves: x[..., 0] = low 64 bits,
x[..., 1] = high 64 bits.  int64 add, sub, neg and << wrap mod 2^64 exactly
as the unsigned operations do; only comparisons differ, so the carry of an
unsigned add compares with the sign bit flipped: a <_u b iff
(a ^ MIN) < (b ^ MIN), MIN = -2^63.
"""

from __future__ import annotations

import numpy as np
import torch

from .torus import MASK32, lsr

MIN64 = -(1 << 63)


def pack(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    return torch.stack([lo, hi], dim=-1)


def unpack(x: torch.Tensor):
    return x[..., 0], x[..., 1]


def _ult(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a < b as unsigned 64-bit words -> int64 0/1."""
    return ((a ^ MIN64) < (b ^ MIN64)).to(torch.int64)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b mod 2^128."""
    alo, ahi = unpack(a)
    blo, bhi = unpack(b)
    lo = alo + blo
    return pack(lo, ahi + bhi + _ult(lo, alo))


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b mod 2^128."""
    alo, ahi = unpack(a)
    blo, bhi = unpack(b)
    return pack(alo - blo, ahi - bhi - _ult(alo, blo))


def neg(a: torch.Tensor) -> torch.Tensor:
    """-a mod 2^128."""
    alo, ahi = unpack(a)
    return pack(-alo, -ahi - (alo != 0).to(torch.int64))


def shl(x: torch.Tensor, k: int) -> torch.Tensor:
    """x << k mod 2^128, for a static 0 <= k < 128."""
    lo, hi = unpack(x)
    if k == 0:
        return x
    if k < 64:
        return pack(lo << k, (hi << k) | lsr(lo, 64 - k))
    return pack(torch.zeros_like(lo), lo << (k - 64))


def from_signed(v: torch.Tensor) -> torch.Tensor:
    """int64 values (any sign) -> their u128 words mod 2^128."""
    return pack(v, v >> 63)


def from_signed_planes(s: torch.Tensor) -> torch.Tensor:
    """[..., m, N] int64 plane values of any sign at weights 2^(32 j) ->
    [..., N, 2] words of sum_j s_j 2^(32 j) mod 2^128."""
    out = from_signed(s[..., 0, :])
    for j in range(1, s.shape[-2]):
        out = add(out, shl(from_signed(s[..., j, :]), 32 * j))
    return out


def to_planes32(x: torch.Tensor) -> torch.Tensor:
    """[..., N, 2] words -> [..., 4, N] int64 planes of 32 unsigned bits
    (weights 2^0, 2^32, 2^64, 2^96)."""
    lo, hi = unpack(x)
    return torch.stack([lo & MASK32, lsr(lo, 32), hi & MASK32, lsr(hi, 32)],
                       dim=-2)


def planes_to_u128(conv: torch.Tensor) -> torch.Tensor:
    """[..., 4, N, 2] words, one per 32-bit plane (weights 2^0 ... 2^96) ->
    [..., N, 2] their weighted sum mod 2^128."""
    out = conv[..., 0, :, :]
    for m in range(1, 4):
        out = add(out, shl(conv[..., m, :, :], 32 * m))
    return out


def monomial_mul(poly: torch.Tensor, degree, N: int) -> torch.Tensor:
    """poly * X^degree negacyclically; poly [..., N, 2], degree an int
    tensor broadcastable against poly.shape[:-2] (or a Python int) in
    [0, 2N] (2N == identity).  One gather, as `polymul.monomial_mul`, with
    the negation carried across the pair."""
    degree = torch.as_tensor(degree, device=poly.device).to(torch.int64)
    deg = torch.remainder(degree, 2 * N).unsqueeze(-1)  # [..., 1]
    j = torch.arange(N, device=poly.device)
    t = torch.remainder(j - deg, 2 * N)
    shape = torch.broadcast_shapes(poly.shape[:-1], t.shape)
    src = torch.remainder(t, N).expand(shape).unsqueeze(-1).expand(
        *shape, 2)
    out = torch.gather(poly.expand(*shape, 2), -2, src)
    return torch.where((t >= N).unsqueeze(-1), neg(out), out)


def monomial_div(poly: torch.Tensor, degree, N: int) -> torch.Tensor:
    """poly * X^{-degree} == poly * X^{2N - degree}."""
    degree = torch.as_tensor(degree, device=poly.device).to(torch.int64)
    return monomial_mul(poly, torch.remainder(2 * N - degree, 2 * N), N)


def to_tensor(pairs: np.ndarray, device) -> torch.Tensor:
    """[..., 2] uint64 pairs (the reference's layout) -> int64 tensor."""
    arr = np.ascontiguousarray(pairs, dtype=np.uint64)
    return torch.from_numpy(arr.view(np.int64).copy()).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int64 pair tensor -> [..., 2] uint64 pairs on the host."""
    return t.detach().to("cpu").contiguous().numpy().view(np.uint64)


# -- host-side helpers (numpy / python ints) --------------------------------


def np_pack(vals) -> np.ndarray:
    """Iterable of python ints (mod 2^128) -> [n, 2] uint64 pairs."""
    vals = [int(v) % (1 << 128) for v in vals]
    lo = np.array([v & 0xFFFFFFFFFFFFFFFF for v in vals], dtype=np.uint64)
    hi = np.array([v >> 64 for v in vals], dtype=np.uint64)
    return np.stack([lo, hi], axis=-1)


def np_unpack(pairs: np.ndarray):
    """[..., 2] uint64 pairs -> list of python ints."""
    flat = np.asarray(pairs, dtype=np.uint64).reshape(-1, 2)
    return [int(lo) | (int(hi) << 64) for lo, hi in flat]
