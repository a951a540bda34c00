"""Shortint client key (port of `tfhe_tpu/shortint/client_key.py`;
ref: tfhe/src/shortint/client_key/mod.rs)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import core
from ..device import resolve_device
from ..ops.torus import to_tensor
from ..params import (ClassicPBSParameters, EncryptionKeyChoice,
                      MultiBitPBSParameters, WopbsParameters)
from ..prng import Seeder, system_seeder
from ..prng.generators import EncryptionRandomGenerator, SecretRandomGenerator
from .ciphertext import Ciphertext, ShortintBatch


class ClientKey:
    def __init__(self, params: ClassicPBSParameters | MultiBitPBSParameters
                 | WopbsParameters, seed: Optional[int] = None,
                 device="cuda"):
        self.params = params
        self.device = resolve_device(device)
        seeder = Seeder(seed) if seed is not None else system_seeder()
        sec = SecretRandomGenerator(seeder.seed())
        self.enc_gen = EncryptionRandomGenerator(seeder.seed(), seeder)
        self.lwe_sk = core.generate_binary_lwe_secret_key(
            params.lwe_dimension, sec, device=self.device)
        self.glwe_sk = core.generate_binary_glwe_secret_key(
            params.glwe_dimension, params.polynomial_size, sec,
            device=self.device)
        self.big_sk = self.glwe_sk.as_lwe_secret_key()
        # the compressed keys draw their public mask seeds from it
        self._seeder = seeder

    @classmethod
    def from_raw(cls, params: ClassicPBSParameters | MultiBitPBSParameters,
                 lwe_sk_bits,
                 glwe_sk_bits, seed: Optional[int] = None,
                 device="cuda") -> "ClientKey":
        """Rebuild a client key from stored secret-key bits; encryption
        randomness is seeded afresh, as in the reference (the RNG lives in
        the engine, not in the serialized key)."""
        self = cls.__new__(cls)
        self.params = params
        self.device = resolve_device(device)
        seeder = Seeder(seed) if seed is not None else system_seeder()
        self.enc_gen = EncryptionRandomGenerator(seeder.seed(), seeder)
        bits = params.torus_bits
        self.lwe_sk = core.LweSecretKey(
            to_tensor(np.asarray(lwe_sk_bits, np.uint64), self.device),
            bits=bits)
        self.glwe_sk = core.GlweSecretKey(
            to_tensor(np.asarray(glwe_sk_bits, np.uint64), self.device),
            bits=bits)
        self.big_sk = self.glwe_sk.as_lwe_secret_key()
        self._seeder = seeder
        return self

    @property
    def encryption_key_and_noise(self):
        if self.params.encryption_key_choice is EncryptionKeyChoice.BIG:
            return self.big_sk, self.params.glwe_modular_std_dev
        return self.lwe_sk, self.params.lwe_modular_std_dev

    # -- batched --

    def encrypt_batch(self, messages) -> ShortintBatch:
        p = self.params
        messages = np.asarray(messages, dtype=np.uint64)
        encoded = (messages % np.uint64(p.total_modulus)) * np.uint64(p.delta)
        sk, std = self.encryption_key_and_noise
        data = core.encrypt_lwe(sk, encoded, std, self.enc_gen)
        return ShortintBatch(
            data=data,
            degrees=np.minimum(messages.astype(np.int64), p.total_modulus - 1),
            message_modulus=p.message_modulus,
            carry_modulus=p.carry_modulus,
        )

    def decrypt_batch_raw(self, data: torch.Tensor) -> np.ndarray:
        """Rounded decode modulo 2*total (includes the padding bit)."""
        p = self.params
        sk, _ = self.encryption_key_and_noise
        phase = core.decrypt_lwe(sk, data).cpu().numpy().view(np.uint64)
        delta = np.uint64(p.delta)
        with np.errstate(over="ignore"):
            return ((phase + (delta >> np.uint64(1))) // delta) % np.uint64(
                2 * p.total_modulus)

    def decrypt_batch(self, batch_or_data) -> np.ndarray:
        data = batch_or_data.data if isinstance(batch_or_data, ShortintBatch) \
            else batch_or_data
        return self.decrypt_batch_raw(data) % np.uint64(
            self.params.message_modulus)

    def decrypt_batch_message_and_carry(self, batch_or_data) -> np.ndarray:
        data = batch_or_data.data if isinstance(batch_or_data, ShortintBatch) \
            else batch_or_data
        return self.decrypt_batch_raw(data) % np.uint64(
            self.params.total_modulus)

    # -- scalar --

    def encrypt(self, message: int) -> Ciphertext:
        b = self.encrypt_batch(np.asarray([message], dtype=np.uint64))
        return Ciphertext(data=b.data[0], degree=int(b.degrees[0]),
                          message_modulus=self.params.message_modulus,
                          carry_modulus=self.params.carry_modulus)

    def decrypt(self, ct: Ciphertext) -> int:
        return int(self.decrypt_batch(ct.data[None])[0])

    def decrypt_message_and_carry(self, ct: Ciphertext) -> int:
        return int(self.decrypt_batch_message_and_carry(ct.data[None])[0])
