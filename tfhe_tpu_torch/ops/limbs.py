"""Signed 8-bit limbs of torus words, and the int8 products built on them.

Port of `tfhe_tpu/ops/limbs.py`.  A torus word x in Z_{2^64} is written as
    x = sum_j m_j * 2^(8j)  (mod 2^64),  m_j in [-128, 127]
via the balanced-byte trick m_j = byte_j(x + 0x8080..80) - 128.  The
products of limbs are int8 x int8 -> int32 matrix products
(`torch._int_mm`), recombined by shifted adds mod 2^64.  They serve the
keyswitch, the packing keyswitches, public-key encryption and the GLWE
phase in key generation, which the reference leaves to XLA einsums or numpy
rather than Pallas kernels.
"""

from __future__ import annotations

import torch

from .torus import lsr, wrap


def n_operand_limbs(base_log: int) -> int:
    """Limbs for a signed decomposition digit in [-B/2, B/2]."""
    t = 1
    while (1 << (base_log - 1)) + int.from_bytes(b"\x80" * t, "little") >= (
            1 << (8 * t)):
        t += 1
    return t


def torus_to_limbs(x: torch.Tensor, bits: int = 64) -> torch.Tensor:
    """[...] int64 torus words -> [..., bits/8] int8 balanced limbs."""
    m = bits // 8
    bias = int.from_bytes(b"\x80" * m, "little")
    if bits == 64 and bias >= 1 << 63:
        bias -= 1 << 64  # the same bits as an int64
    y = wrap(x + bias, bits)
    return torch.stack(
        [((lsr(y, 8 * j, bits) & 0xFF) - 128).to(torch.int8)
         for j in range(m)], dim=-1)


def digits_to_limbs(d: torch.Tensor, base_log: int) -> torch.Tensor:
    """[...] signed digits in [-B/2, B/2] -> [..., t] int8 limbs."""
    t = n_operand_limbs(base_log)
    y = d.to(torch.int64) + int.from_bytes(b"\x80" * t, "little")
    return torch.stack([(((y >> (8 * j)) & 0xFF) - 128).to(torch.int8)
                        for j in range(t)], dim=-1)


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[m, k] int8 @ [k, n] int8 -> [m, n] int32, exactly.

    On CUDA `torch._int_mm` wants more than 16 rows and k, n multiples of 8:
    the operands are zero-padded to that and the result cut back."""
    m, k = a.shape
    n = b.shape[1]
    if a.device.type != "cuda":
        return torch._int_mm(a, b)
    mp, kp, np_ = max(_round_up(m, 8), 24), _round_up(k, 8), _round_up(n, 8)
    if (mp, kp) != (m, k):
        a = torch.nn.functional.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        b = torch.nn.functional.pad(b, (0, np_ - n, 0, kp - k))
    return torch._int_mm(a.contiguous(), b.contiguous())[:m, :n]


def combine_limb_products(prod: torch.Tensor, limb_axes: tuple[int, int],
                          bits: int = 64) -> torch.Tensor:
    """sum_{i,m} prod[.., i, .., m, ..] << 8(i+m)  (mod 2^bits), dropping the
    pairs whose weight is a multiple of 2^bits.  prod is int32; the two limb
    axes are removed from the result (int64)."""
    ax_i, ax_m = (a % prod.dim() for a in limb_axes)
    if ax_i >= ax_m:
        raise ValueError("pass limb axes as (operand_axis, key_axis), in order")
    ni, nm = prod.shape[ax_i], prod.shape[ax_m]
    acc = None
    for i in range(ni):
        pi = prod.select(ax_i, i)
        for m in range(nm):
            s = 8 * (i + m)
            if s >= bits:
                continue
            term = pi.select(ax_m - 1, m).to(torch.int64) << s
            acc = term if acc is None else acc + term
    return wrap(acc, bits)


def key_limb_matrix(key: torch.Tensor, bits: int = 64) -> torch.Tensor:
    """Torus words [K, C] -> the int8 matrix [K, M*C] of their limbs (limb
    major), the right operand of `digits_times_key`."""
    K, C = key.shape
    return torus_to_limbs(key, bits).permute(0, 2, 1).reshape(K, -1
                                                             ).contiguous()


def digits_times_key(digits: torch.Tensor, base_log: int,
                     matrix: torch.Tensor, bits: int = 64) -> torch.Tensor:
    """sum_k digits[b, k] * key[k, c] (mod 2^bits) -> [B, C] int64, as one
    int8 product: digits [B, K] signed, |d| <= 2^(base_log-1) (base_log 1
    for 0/1 choices), matrix `key_limb_matrix(key)`.  Exact while
    128 * 128 * K < 2^31."""
    B, K = digits.shape
    m = bits // 8
    C = matrix.shape[1] // m
    dl = digits_to_limbs(digits, base_log)  # [B, K, t]
    t = dl.shape[-1]
    a = dl.permute(0, 2, 1).reshape(B * t, K).contiguous()
    prod = int8_matmul(a, matrix).reshape(B, t, m, C)
    return combine_limb_products(prod, (1, 2), bits)
