"""Shortint public keys: standard and compact.

Port of `tfhe_tpu/shortint/public_key.py` (ref: tfhe/src/shortint/
public_key/{standard.rs, compact.rs} and engine/public_side.rs): the
shortint layer wraps the core public-key encryption with message encoding
and degree bookkeeping.  Keys and ciphertexts live on the client key's
device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core import public_key as core_pk
from ..params import ClassicPBSParameters, EncryptionKeyChoice
from ..prng import Seeder, system_seeder
from ..prng.generators import EncryptionRandomGenerator, SecretRandomGenerator
from .ciphertext import ShortintBatch
from .client_key import ClientKey


def _encode(params: ClassicPBSParameters, messages) -> np.ndarray:
    messages = np.asarray(messages, dtype=np.uint64)
    return (messages % np.uint64(params.total_modulus)) * np.uint64(
        params.delta)


def _degrees(params: ClassicPBSParameters, messages) -> np.ndarray:
    m = np.asarray(messages, dtype=np.int64)
    return np.minimum(m % params.total_modulus, params.total_modulus - 1)


class _EncryptorRng:
    """A fresh public-party RNG pair for public-key encryption (the
    encryptor holds no secret of the key owner)."""

    def __init__(self, seed: Optional[int] = None):
        seeder = Seeder(seed) if seed is not None else system_seeder()
        self.secret = SecretRandomGenerator(seeder.seed())
        self.enc = EncryptionRandomGenerator(seeder.seed(), seeder)


class PublicKey:
    """Standard LWE public key: (n+1)*64 + 128 encryptions of zero
    (ref: shortint/public_key/standard.rs; count formula
    engine/public_side.rs:13-20)."""

    def __init__(self, cks: ClientKey):
        p = cks.params
        self.params = p
        sk, std = cks.encryption_key_and_noise
        count = core_pk.public_key_zero_encryption_count(
            sk.lwe_dimension + 1, p.torus_bits)
        self.key = core_pk.generate_lwe_public_key(sk, count, std,
                                                   cks.enc_gen)

    def encrypt_batch(self, messages,
                      seed: Optional[int] = None) -> ShortintBatch:
        p = self.params
        rng = _EncryptorRng(seed)
        data = core_pk.encrypt_lwe_with_public_key(
            self.key, _encode(p, messages), rng.secret)
        return ShortintBatch(data=data, degrees=_degrees(p, messages),
                             message_modulus=p.message_modulus,
                             carry_modulus=p.carry_modulus)


class CompactPublicKey:
    """Compact (Joye-style) public key: one (mask, body) pair of the
    encryption dimension (ref: shortint/public_key/compact.rs)."""

    def __init__(self, cks: ClientKey):
        p = cks.params
        self.params = p
        sk, std = cks.encryption_key_and_noise
        self.key = core_pk.generate_lwe_compact_public_key(sk, std,
                                                           cks.enc_gen)

    def encrypt_batch(self, messages,
                      seed: Optional[int] = None) -> ShortintBatch:
        return self.encrypt_compact_batch(messages, seed=seed).expand()

    def encrypt_compact_batch(self, messages, seed: Optional[int] = None
                              ) -> "CompactCiphertextList":
        p = self.params
        rng = _EncryptorRng(seed)
        std = p.glwe_modular_std_dev \
            if p.encryption_key_choice is EncryptionKeyChoice.BIG \
            else p.lwe_modular_std_dev
        compact = core_pk.encrypt_compact_lwe_list(
            self.key, _encode(p, messages), std, std, rng.secret, rng.enc)
        return CompactCiphertextList(compact=compact,
                                     degrees=_degrees(p, messages),
                                     message_modulus=p.message_modulus,
                                     carry_modulus=p.carry_modulus)


class CompressedPublicKey:
    """Seeded standard public key: only the zero encryptions' bodies travel
    (ref: shortint/public_key/compressed.rs)."""

    def __init__(self, cks: ClientKey):
        p = cks.params
        self.params = p
        sk, std = cks.encryption_key_and_noise
        count = core_pk.public_key_zero_encryption_count(
            sk.lwe_dimension + 1, p.torus_bits)
        self.seeded = core_pk.generate_seeded_lwe_public_key(
            sk, count, std, cks._seeder)

    def decompress(self) -> PublicKey:
        pk = PublicKey.__new__(PublicKey)
        pk.params = self.params
        pk.key = core_pk.decompress_lwe_public_key(self.seeded)
        return pk


class CompressedCompactPublicKey:
    """Seeded compact public key
    (ref: shortint/public_key/compact.rs CompressedCompactPublicKey)."""

    def __init__(self, cks: ClientKey):
        p = cks.params
        self.params = p
        sk, std = cks.encryption_key_and_noise
        self.seeded = core_pk.generate_seeded_lwe_compact_public_key(
            sk, std, cks._seeder)

    def decompress(self) -> CompactPublicKey:
        pk = CompactPublicKey.__new__(CompactPublicKey)
        pk.params = self.params
        pk.key = core_pk.decompress_lwe_compact_public_key(self.seeded)
        return pk


class CompactCiphertextList:
    """Compact list of fresh shortint encryptions; `expand()` gives the
    working ShortintBatch (ref: shortint/ciphertext/mod.rs
    CompactCiphertextList + expand)."""

    def __init__(self, compact: core_pk.CompactLweCiphertextList,
                 degrees: np.ndarray, message_modulus: int,
                 carry_modulus: int):
        self.compact = compact
        self.degrees = np.asarray(degrees, dtype=np.int64)
        self.message_modulus = message_modulus
        self.carry_modulus = carry_modulus

    def __len__(self) -> int:
        return len(self.compact)

    def expand(self) -> ShortintBatch:
        return ShortintBatch(data=core_pk.expand_compact_lwe_list(
            self.compact), degrees=self.degrees.copy(),
            message_modulus=self.message_modulus,
            carry_modulus=self.carry_modulus)

    def _conformance_check(self, params) -> None:
        from ..utils.serialization import ConformanceError

        if (self.message_modulus != params.message_modulus
                or self.carry_modulus != params.carry_modulus):
            raise ConformanceError("modulus mismatch")
        if self.compact.lwe_dimension + 1 != params.ciphertext_lwe_size:
            raise ConformanceError(
                f"LWE dimension mismatch: {self.compact.lwe_dimension} != "
                f"params {params.ciphertext_lwe_size - 1}")
