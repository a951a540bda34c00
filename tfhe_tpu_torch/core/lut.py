"""Accumulator (LUT) construction for the programmable bootstrap.

Port of `tfhe_tpu/core/lut.py` (ref: tfhe/src/shortint/engine/mod.rs:72-128):
the test polynomial holds f(i) * delta in boxes of N/(msg*carry)
coefficients, with the first half-box negated and the polynomial rotated
left by half a box so that rounding errors around the encoded value land in
the right box.  Built on the host, returned on `device`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops import u128
from ..ops.torus import to_tensor


def fill_accumulator(f, polynomial_size: int, glwe_size: int,
                     modulus_sup: int, delta: int, bits: int = 64,
                     device="cuda"):
    """Trivial-GLWE LUT for x -> f(x): (glwe [G, N] int64, max of f)."""
    device = resolve_device(device)
    dt = np.uint64 if bits == 64 else np.uint32
    N = polynomial_size
    box_size = N // modulus_sup
    body = np.zeros(N, dtype=dt)
    max_value = 0
    with np.errstate(over="ignore"):
        for i in range(modulus_sup):
            f_eval = int(f(i)) % (1 << bits)
            max_value = max(max_value, f_eval)
            body[i * box_size:(i + 1) * box_size] = dt(
                (f_eval * delta) % (1 << bits))
        half_box = box_size // 2
        body[:half_box] = dt(0) - body[:half_box]
        body = np.roll(body, -half_box)
    out = np.zeros((glwe_size, N), dtype=dt)
    out[-1] = body
    return to_tensor(out, device), max_value


def make_lut_glwe(values, polynomial_size: int, glwe_size: int,
                  modulus_sup: int, delta: int, bits: int = 64,
                  device="cuda"):
    """LUT from an explicit table values[i] (i in [0, modulus_sup))."""
    return fill_accumulator(lambda i: values[i], polynomial_size, glwe_size,
                            modulus_sup, delta, bits=bits, device=device)


def fill_accumulator_u128(f, polynomial_size: int, glwe_size: int,
                          modulus_sup: int, delta: int,
                          device="cuda") -> torch.Tensor:
    """u128-torus LUT accumulator -> [G, N, 2] int64 (lo, hi) words, built
    on the host in Python integers (tfhe_tpu/core/lut.py:49-69)."""
    device = resolve_device(device)
    MOD = 1 << 128
    N = polynomial_size
    box = N // modulus_sup
    body = [0] * N
    for i in range(modulus_sup):
        v = (int(f(i)) * delta) % MOD
        for t in range(i * box, (i + 1) * box):
            body[t] = v
    half = box // 2
    for t in range(half):
        body[t] = (-body[t]) % MOD
    body = body[half:] + body[:half]
    out = np.zeros((glwe_size, N, 2), dtype=np.uint64)
    out[-1] = u128.np_pack(body)
    return u128.to_tensor(out, device)
