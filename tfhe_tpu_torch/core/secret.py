"""Secret keys and the binary negacyclic phase.

Port of `tfhe_tpu/core/secret.py`
(ref: tfhe/src/core_crypto/entities/{lwe_secret_key.rs, glwe_secret_key.rs}).
Key bits are int64 tensors of 0/1 on the key's device.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops import limbs


@dataclass
class LweSecretKey:
    bits_array: torch.Tensor  # [n] int64 of 0/1
    bits: int = 64

    @property
    def lwe_dimension(self) -> int:
        return self.bits_array.shape[0]


@dataclass
class GlweSecretKey:
    bits_array: torch.Tensor  # [k, N] int64 of 0/1
    bits: int = 64

    @property
    def glwe_dimension(self) -> int:
        return self.bits_array.shape[0]

    @property
    def polynomial_size(self) -> int:
        return self.bits_array.shape[1]

    def as_lwe_secret_key(self) -> LweSecretKey:
        """Flatten to the equivalent big LWE key (k*N bits)
        (ref: glwe_secret_key.rs into_lwe_secret_key)."""
        return LweSecretKey(self.bits_array.reshape(-1), bits=self.bits)


def binary_ext_matrix(sk_bits: torch.Tensor) -> torch.Tensor:
    """[k, N] binary key -> [k, N, N] int8 negacyclic matrices:
    M[n, n'] = ext[(n' - n) mod 2N] with ext = (s, -s)."""
    N = sk_bits.shape[-1]
    s8 = sk_bits.to(torch.int8)
    ext = torch.cat([s8, -s8], dim=-1)  # [k, 2N]
    n = torch.arange(N, device=sk_bits.device)
    idx = torch.remainder(n[None, :] - n[:, None], 2 * N)  # [N, N']
    return ext[:, idx]


def glwe_phase(sk_bits: torch.Tensor, masks: torch.Tensor,
               bits: int = 64) -> torch.Tensor:
    """sum_j s_j (*) mask_j over the negacyclic ring, exactly.

    sk_bits [k, N] 0/1, masks [..., k, N] int64 torus words -> [..., N].
    The int8 limbs of the masks meet the +-1/0 key matrices in one int8
    matrix product (|sum| <= 128 * k * N, far inside int32)."""
    k, N = sk_bits.shape
    lead = masks.shape[:-2]
    m = bits // 8
    ml = limbs.torus_to_limbs(masks.reshape(-1, k, N), bits)  # [R, k, N, m]
    a = ml.permute(0, 3, 1, 2).reshape(-1, k * N)  # [R*m, k*N]
    smat = binary_ext_matrix(sk_bits).reshape(k * N, N)
    prod = limbs.int8_matmul(a, smat).reshape(-1, 1, m, N)  # [R, 1, m, N]
    return limbs.combine_limb_products(prod, (1, 2), bits).reshape(*lead, N)
