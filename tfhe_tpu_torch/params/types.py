"""Parameter dataclasses (copy of `tfhe_tpu/params/types.py`: classic and
multi-bit PBS, WoPBS, and boolean).

A frozen dataclass carries plain ints plus derived helpers, so parameter sets
are hashable and compare field by field with the reference's.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class EncryptionKeyChoice(enum.Enum):
    """Which key fresh ciphertexts are encrypted under.

    BIG   -> ciphertexts live under the large (GLWE-derived) key; a shortint
             operation runs keyswitch-then-PBS (PBSOrder.KEYSWITCH_BOOTSTRAP).
    SMALL -> ciphertexts live under the small LWE key; operations run
             PBS-then-keyswitch (PBSOrder.BOOTSTRAP_KEYSWITCH).
    (ref: tfhe/src/shortint/parameters/mod.rs EncryptionKeyChoice/PBSOrder)
    """

    BIG = "big"
    SMALL = "small"


class PBSOrder(enum.Enum):
    KEYSWITCH_BOOTSTRAP = "ks_pbs"
    BOOTSTRAP_KEYSWITCH = "pbs_ks"


@dataclass(frozen=True)
class ClassicPBSParameters:
    """Classic-PBS shortint parameters (ref: shortint/parameters/mod.rs)."""

    name: str
    lwe_dimension: int
    glwe_dimension: int
    polynomial_size: int
    lwe_modular_std_dev: float
    glwe_modular_std_dev: float
    pbs_base_log: int
    pbs_level: int
    ks_base_log: int
    ks_level: int
    message_modulus: int
    carry_modulus: int
    encryption_key_choice: EncryptionKeyChoice = EncryptionKeyChoice.BIG
    torus_bits: int = 64

    @property
    def glwe_size(self) -> int:
        return self.glwe_dimension + 1

    @property
    def big_lwe_dimension(self) -> int:
        """LWE dimension after sample extraction (k * N)."""
        return self.glwe_dimension * self.polynomial_size

    @property
    def pbs_order(self) -> PBSOrder:
        if self.encryption_key_choice is EncryptionKeyChoice.BIG:
            return PBSOrder.KEYSWITCH_BOOTSTRAP
        return PBSOrder.BOOTSTRAP_KEYSWITCH

    @property
    def total_modulus(self) -> int:
        """message_modulus * carry_modulus (the cleartext space of one block)."""
        return self.message_modulus * self.carry_modulus

    @property
    def delta(self) -> int:
        """Plaintext scaling: 2^(bits-1) / (msg*carry) — one padding bit.

        (ref: shortint/engine/mod.rs fill_accumulator `delta`)
        """
        return (1 << (self.torus_bits - 1)) // self.total_modulus

    @property
    def max_degree(self) -> int:
        return self.total_modulus - 1

    @property
    def max_noise_level(self) -> int:
        """(ref: shortint/ciphertext/mod.rs:44-49
        MaxNoiseLevel::from_msg_carry_modulus)"""
        return (self.carry_modulus * self.message_modulus - 1) // (
            self.message_modulus - 1)

    @property
    def ciphertext_lwe_size(self) -> int:
        """Length of a fresh ciphertext vector under the encryption key."""
        if self.encryption_key_choice is EncryptionKeyChoice.BIG:
            return self.big_lwe_dimension + 1
        return self.lwe_dimension + 1


@dataclass(frozen=True)
class MultiBitPBSParameters:
    """Multi-bit PBS parameters (ref: shortint/parameters/multi_bit.rs).

    Copy of `tfhe_tpu/params/types.py:100-126`, with the classic type's
    `ciphertext_lwe_size` besides, which the port's ServerKey reads."""

    name: str
    lwe_dimension: int
    glwe_dimension: int
    polynomial_size: int
    lwe_modular_std_dev: float
    glwe_modular_std_dev: float
    pbs_base_log: int
    pbs_level: int
    ks_base_log: int
    ks_level: int
    message_modulus: int
    carry_modulus: int
    grouping_factor: int
    deterministic_execution: bool = True  # every sum has a fixed order
    encryption_key_choice: EncryptionKeyChoice = EncryptionKeyChoice.BIG
    torus_bits: int = 64

    glwe_size = ClassicPBSParameters.glwe_size
    big_lwe_dimension = ClassicPBSParameters.big_lwe_dimension
    pbs_order = ClassicPBSParameters.pbs_order
    total_modulus = ClassicPBSParameters.total_modulus
    delta = ClassicPBSParameters.delta
    max_degree = ClassicPBSParameters.max_degree
    max_noise_level = ClassicPBSParameters.max_noise_level
    ciphertext_lwe_size = ClassicPBSParameters.ciphertext_lwe_size


@dataclass(frozen=True)
class WopbsParameters:
    """Without-padding-PBS parameters
    (ref: shortint/parameters/mod.rs WopbsParameters)."""

    name: str
    lwe_dimension: int
    glwe_dimension: int
    polynomial_size: int
    lwe_modular_std_dev: float
    glwe_modular_std_dev: float
    pbs_base_log: int
    pbs_level: int
    ks_base_log: int
    ks_level: int
    pfks_base_log: int
    pfks_level: int
    pfks_modular_std_dev: float
    cbs_base_log: int
    cbs_level: int
    message_modulus: int
    carry_modulus: int
    encryption_key_choice: EncryptionKeyChoice = EncryptionKeyChoice.BIG
    torus_bits: int = 64

    glwe_size = ClassicPBSParameters.glwe_size
    big_lwe_dimension = ClassicPBSParameters.big_lwe_dimension
    pbs_order = ClassicPBSParameters.pbs_order
    total_modulus = ClassicPBSParameters.total_modulus
    delta = ClassicPBSParameters.delta
    max_degree = ClassicPBSParameters.max_degree
    max_noise_level = ClassicPBSParameters.max_noise_level
    ciphertext_lwe_size = ClassicPBSParameters.ciphertext_lwe_size


@dataclass(frozen=True)
class BooleanParameters:
    """Boolean-scheme parameters over the u32 torus.

    (ref: tfhe/src/boolean/parameters/mod.rs:123-194)
    """

    name: str
    lwe_dimension: int
    glwe_dimension: int
    polynomial_size: int
    lwe_modular_std_dev: float
    glwe_modular_std_dev: float
    pbs_base_log: int
    pbs_level: int
    ks_base_log: int
    ks_level: int
    encryption_key_choice: EncryptionKeyChoice = EncryptionKeyChoice.SMALL
    torus_bits: int = 32

    @property
    def glwe_size(self) -> int:
        return self.glwe_dimension + 1

    @property
    def big_lwe_dimension(self) -> int:
        return self.glwe_dimension * self.polynomial_size

    @property
    def pbs_order(self) -> PBSOrder:
        if self.encryption_key_choice is EncryptionKeyChoice.BIG:
            return PBSOrder.KEYSWITCH_BOOTSTRAP
        return PBSOrder.BOOTSTRAP_KEYSWITCH
