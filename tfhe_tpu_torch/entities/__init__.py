"""Ciphertext and key containers.

Port of `tfhe_tpu/entities` (ref: tfhe/src/core_crypto/entities/): thin
dataclasses over int64 tensors (torus words) with static shape metadata.
The reference registers them as JAX pytrees; here they are plain
dataclasses.  The seeded twin stores (seed, body) and regenerates the mask
from the CSPRNG on decompression (`core.seeded`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class LweCiphertext:
    """LWE ciphertext(s): data [..., lwe_dimension + 1], last element = body
    (ref: entities/lwe_ciphertext.rs)."""

    data: torch.Tensor
    bits: int = 64

    @property
    def lwe_dimension(self) -> int:
        return self.data.shape[-1] - 1

    @property
    def mask(self) -> torch.Tensor:
        return self.data[..., :-1]

    @property
    def body(self) -> torch.Tensor:
        return self.data[..., -1]


@dataclass
class GlweCiphertext:
    """GLWE ciphertext(s): data [..., glwe_size, N]; last polynomial = body
    (ref: entities/glwe_ciphertext.rs)."""

    data: torch.Tensor
    bits: int = 64

    @property
    def glwe_size(self) -> int:
        return self.data.shape[-2]

    @property
    def polynomial_size(self) -> int:
        return self.data.shape[-1]

    @property
    def mask(self) -> torch.Tensor:
        return self.data[..., :-1, :]

    @property
    def body(self) -> torch.Tensor:
        return self.data[..., -1, :]


@dataclass
class GgswCiphertext:
    """GGSW ciphertext: data [levels, glwe_size (row j), glwe_size (poly o),
    N]; level j encrypts with factor -m * q/B^(j+1)
    (ref: entities/ggsw_ciphertext.rs; algorithms/ggsw_encryption.rs:
    72-151)."""

    data: torch.Tensor
    base_log: int
    bits: int = 64

    @property
    def levels(self) -> int:
        return self.data.shape[0]


@dataclass
class LweBootstrapKey:
    """Standard-domain bootstrap key: data [n_in, levels, G, G, N]
    (ref: entities/lwe_bootstrap_key.rs)."""

    data: torch.Tensor
    base_log: int
    bits: int = 64


@dataclass
class LweKeyswitchKey:
    """Keyswitch key: data [n_in, levels, n_out + 1]; level j holds
    encryptions of s_i * q/B^(j+1) (ref: entities/lwe_keyswitch_key.rs)."""

    data: torch.Tensor
    base_log: int
    bits: int = 64


@dataclass
class SeededLweCiphertext:
    """Compressed LWE: (mask_seed, body); decompression regenerates the
    mask from the public AES-CTR stream."""

    body: torch.Tensor
    mask_seed: int
    lwe_dimension: int
    bits: int = 64


__all__ = [
    "LweCiphertext", "GlweCiphertext", "GgswCiphertext", "LweBootstrapKey",
    "LweKeyswitchKey", "SeededLweCiphertext",
]
