"""Negacyclic monomial products in Z_q[X]/(X^N + 1).

Port of `monomial_mul` / `monomial_div` in `tfhe_tpu/ops/polymul.py:46,77`
(ref: polynomial_algorithms.rs polynomial_wrapping_monic_monomial_{mul,div}).
The TPU version is a barrel shifter of static rolls; here it is one gather.
"""

from __future__ import annotations

import torch

from .torus import wrap


def monomial_mul(poly: torch.Tensor, degree, N: int,
                 bits: int = 64) -> torch.Tensor:
    """poly * X^degree; degree in [0, 2N] (2N == identity).

    poly: [..., N] int64 torus words; degree: int tensor broadcastable
    against poly.shape[:-1] (or a Python int).
    """
    degree = torch.as_tensor(degree, device=poly.device).to(torch.int64)
    deg = torch.remainder(degree, 2 * N).unsqueeze(-1)  # [..., 1]
    j = torch.arange(N, device=poly.device)
    # coefficient j of poly * X^d is +-poly[(j - d) mod N], negated when
    # (j - d) mod 2N wraps past N (X^N == -1)
    t = torch.remainder(j - deg, 2 * N)
    shape = torch.broadcast_shapes(poly.shape, t.shape)
    src = torch.remainder(t, N).expand(shape)
    out = torch.gather(poly.expand(shape), -1, src)
    return wrap(torch.where(t >= N, -out, out), bits)


def monomial_div(poly: torch.Tensor, degree, N: int,
                 bits: int = 64) -> torch.Tensor:
    """poly * X^{-degree} == poly * X^{2N - degree}."""
    degree = torch.as_tensor(degree, device=poly.device).to(torch.int64)
    return monomial_mul(poly, torch.remainder(2 * N - degree, 2 * N), N,
                        bits=bits)
