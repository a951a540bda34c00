"""Shortint ciphertexts with host-side health metadata.

Port of `tfhe_tpu/shortint/ciphertext.py` (ref: tfhe/src/shortint/ciphertext/
mod.rs:27-259).  The LWE data is an int64 tensor on the key's device;
degree and noise level are numpy bookkeeping, as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


NOMINAL_NOISE = 1


@dataclass
class Ciphertext:
    """One shortint block: LWE data + (degree, noise_level) metadata."""

    data: torch.Tensor  # [lwe_size] int64
    degree: int
    message_modulus: int
    carry_modulus: int
    noise_level: int = NOMINAL_NOISE
    is_trivial: bool = False


@dataclass
class ShortintBatch:
    """A batch of shortint blocks, the unit every PBS call works on.

    data [B, lwe_size] int64 tensor; degrees / noise [B] host metadata."""

    data: torch.Tensor
    degrees: np.ndarray
    message_modulus: int
    carry_modulus: int
    noise: np.ndarray = None

    def __post_init__(self):
        if self.noise is None:
            self.noise = np.full(self.data.shape[0], NOMINAL_NOISE,
                                 dtype=np.int64)
        self.degrees = np.asarray(self.degrees, dtype=np.int64)

    def __len__(self):
        return self.data.shape[0]
