"""Shortint ciphertexts with host-side health metadata.

Port of `tfhe_tpu/shortint/ciphertext.py` (ref: tfhe/src/shortint/ciphertext/
mod.rs:27-259).  The LWE data is an int64 tensor on the key's device;
degree and noise level are numpy bookkeeping, as in the reference: `checked_`
operations validate them against the server key's maximum degree and noise
level, and the op families use them to decide when to clean a carry.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


class CheckError(Exception):
    """Raised when an operation would overflow the degree or noise budget
    (ref: shortint/server_key/mod.rs CheckError)."""


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

    def copy(self) -> "Ciphertext":
        return Ciphertext(data=self.data.clone(), degree=self.degree,
                          message_modulus=self.message_modulus,
                          carry_modulus=self.carry_modulus,
                          noise_level=self.noise_level,
                          is_trivial=self.is_trivial)

    @property
    def total_modulus(self) -> int:
        return self.message_modulus * self.carry_modulus

    def carry_is_empty(self) -> bool:
        return self.degree < self.message_modulus


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

    def copy(self) -> "ShortintBatch":
        return ShortintBatch(self.data.clone(), self.degrees.copy(),
                             self.message_modulus, self.carry_modulus,
                             self.noise.copy())

    def _conformance_check(self, params) -> None:
        """Structural conformance against a parameter set: the moduli and
        the LWE size must match (tfhe_tpu/shortint/ciphertext.py:82-99;
        ref: tfhe/src/conformance.rs ParameterSetConformant)."""
        from ..utils.serialization import ConformanceError

        if (self.message_modulus != params.message_modulus
                or self.carry_modulus != params.carry_modulus):
            raise ConformanceError(
                f"modulus mismatch: ct ({self.message_modulus},"
                f"{self.carry_modulus}) != params "
                f"({params.message_modulus},{params.carry_modulus})"
            )
        if self.data.shape[-1] != params.ciphertext_lwe_size:
            raise ConformanceError(
                f"LWE size mismatch: ct {self.data.shape[-1]} != params "
                f"{params.ciphertext_lwe_size}"
            )
