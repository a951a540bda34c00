"""Signed gadget decomposition on int64 torus tensors.

Port of `tfhe_tpu/ops/decomposition.py` (ref: tfhe/src/core_crypto/commons/
math/decomposition/decomposer.rs:98-118 `closest_representable`;
decomposition/iter.rs:120-127 `decompose_one_level`).

Digit index j corresponds to decomposition level l = j+1, i.e. weight
q / B^(j+1) (largest weight first), as in the reference.
"""

from __future__ import annotations

import torch

from .torus import lsr, wrap


def closest_representable(x: torch.Tensor, base_log: int, levels: int,
                          bits: int = 64) -> torch.Tensor:
    """Round x to the nearest multiple of q / B^levels (the reference's
    shift-and-mask formulation)."""
    non_rep = bits - levels * base_log
    if non_rep < 1:
        raise ValueError("decomposition must leave at least one bit")
    shift = non_rep - 1
    res = lsr(x, shift, bits) + 1
    res = res & ~1
    return wrap(res << shift, bits)


def signed_decompose(x: torch.Tensor, base_log: int, levels: int,
                     bits: int = 64) -> torch.Tensor:
    """Signed decomposition -> int32 digits [..., levels]; digit j has weight
    q/B^(j+1) and lies in [-B/2, B/2]."""
    x = closest_representable(x, base_log, levels, bits)
    # < 2^(bits-1): every value below is non-negative, so >> is logical
    state = lsr(x, bits - base_log * levels, bits)
    mod_b_mask = (1 << base_log) - 1
    digits = []
    for _ in range(levels):
        res = state & mod_b_mask
        state = state >> base_log
        carry = ((res - 1) | state) & res
        carry = carry >> (base_log - 1)
        state = state + carry
        digits.append((res - (carry << base_log)).to(torch.int32))
    # emitted smallest weight (level=levels) first; return largest first
    digits.reverse()
    return torch.stack(digits, dim=-1)
