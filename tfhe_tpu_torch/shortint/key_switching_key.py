"""Casting keyswitch key: move ciphertexts between parameter sets.

Port of `tfhe_tpu/shortint/key_switching_key.py` (ref: tfhe/src/shortint/
key_switching_key/mod.rs:21-181): the client publishes a keyswitch key
from its source encryption key to the destination encryption key; casting
keyswitches and, when the plaintext spaces differ, rescales through a
shift LUT under whichever key has the larger space.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import core
from .ciphertext import Ciphertext, ShortintBatch
from .client_key import ClientKey
from .server_key import ServerKey


@dataclass(frozen=True)
class ShortintKeySwitchingParameters:
    """(ref: shortint/parameters/key_switching.rs:7-10)"""

    ks_base_log: int
    ks_level: int


#: (ref: shortint/parameters/key_switching.rs:29-33)
PARAM_KEYSWITCH_1_1_KS_PBS_TO_2_2_KS_PBS = ShortintKeySwitchingParameters(
    ks_base_log=1, ks_level=15)


class KeySwitchingKey:
    """Public casting key between two (ClientKey, ServerKey) pairs on one
    device (ref: key_switching_key/mod.rs KeySwitchingKey)."""

    def __init__(self, src: tuple[ClientKey, ServerKey],
                 dst: tuple[ClientKey, ServerKey],
                 params: ShortintKeySwitchingParameters):
        cks1, sks1 = src
        cks2, sks2 = dst
        total1 = cks1.params.total_modulus
        total2 = cks2.params.total_modulus
        if total1 & (total1 - 1) or total2 & (total2 - 1):
            raise ValueError(
                "casting requires power-of-two full message moduli")
        in_sk, _ = cks1.encryption_key_and_noise
        out_sk, out_std = cks2.encryption_key_and_noise
        raw = core.generate_keyswitch_key(in_sk, out_sk, params.ks_base_log,
                                          params.ks_level, out_std,
                                          cks2.enc_gen)
        self.raw_ksk = raw
        self.ksk = core.prepare_ksk(raw, params.ks_base_log)
        self.src_server_key = sks1
        self.dest_server_key = sks2
        # positive: the destination has more plaintext bits
        self.cast_rshift = ((total2.bit_length() - 1)
                            - (total1.bit_length() - 1))

    def cast_batch(self, batch: ShortintBatch) -> ShortintBatch:
        """(ref: key_switching_key/mod.rs:113-180 cast_into/cast)"""
        dst_sks = self.dest_server_key
        shift = self.cast_rshift
        if shift < 0:
            # the destination space is smaller: scale up under the source
            # key first so the keyswitched encoding lands on its delta
            total1 = self.src_server_key.params.total_modulus
            lut = self.src_server_key.generate_lookup_table(
                lambda n: (n << -shift) % total1)
            batch = self.src_server_key.apply_lookup_table_batch(batch, lut)
        out = ShortintBatch(data=core.keyswitch(self.ksk, batch.data),
                            degrees=batch.degrees.copy(),
                            message_modulus=dst_sks.message_modulus,
                            carry_modulus=dst_sks.carry_modulus)
        if shift > 0:
            lut = dst_sks.generate_lookup_table(lambda n: n >> shift)
            out = dst_sks.apply_lookup_table_batch(out, lut)
        out.degrees = np.minimum(out.degrees, dst_sks.max_degree)
        return out

    def cast(self, ct: Ciphertext) -> Ciphertext:
        """One ciphertext (ref: mod.rs:176-180)."""
        b = ShortintBatch(data=ct.data[None], degrees=np.array([ct.degree]),
                          message_modulus=ct.message_modulus,
                          carry_modulus=ct.carry_modulus)
        out = self.cast_batch(b)
        return Ciphertext(data=out.data[0], degree=int(out.degrees[0]),
                          message_modulus=out.message_modulus,
                          carry_modulus=out.carry_modulus)
