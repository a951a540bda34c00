"""Batched LWE keyswitch as one int8 matrix product.

Port of `tfhe_tpu/core/keyswitch.py:17-39` (ref: algorithms/
lwe_keyswitch.rs:143-169): the output is (0,...,0, body_in) minus the sum
over input mask elements and levels of digit * KSK_row.  All digits of the
batch meet the KSK's limbs in one `torch._int_mm`, which the reference
leaves to an XLA einsum (no Pallas kernel).
"""

from __future__ import annotations

import torch

from ..ops import decomposition, limbs
from ..ops.torus import wrap
from .keygen import PreparedKsk


def keyswitch(ksk: PreparedKsk, ct: torch.Tensor) -> torch.Tensor:
    """ct [..., n_in+1] int64 -> [..., n_out+1] int64."""
    bits = ksk.bits
    lead = ct.shape[:-1]
    ct = ct.reshape(-1, ct.shape[-1])
    B, n_in = ct.shape[0], ct.shape[1] - 1
    digits = decomposition.signed_decompose(ct[:, :-1], ksk.base_log,
                                            ksk.levels, bits=bits)
    dl = limbs.digits_to_limbs(digits, ksk.base_log)  # [B, n_in, L, I]
    n_limbs = dl.shape[-1]
    a = dl.permute(0, 3, 1, 2).reshape(B * n_limbs, n_in * ksk.levels)
    prod = limbs.int8_matmul(a.contiguous(), ksk.matrix)
    prod = prod.reshape(B, n_limbs, bits // 8, ksk.out_dim + 1)
    acc = limbs.combine_limb_products(prod, (1, 2), bits)  # [B, n_out+1]
    out = torch.zeros_like(acc)
    out[:, -1] = ct[:, -1]
    return wrap(out - acc, bits).reshape(*lead, ksk.out_dim + 1)
