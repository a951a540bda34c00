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
    acc = limbs.digits_times_key(digits.reshape(B, n_in * ksk.levels),
                                 ksk.base_log, ksk.matrix, bits)
    out = torch.zeros_like(acc)
    out[:, -1] = ct[:, -1]
    return wrap(out - acc, bits).reshape(*lead, ksk.out_dim + 1)
