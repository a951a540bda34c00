"""Compressed (seeded) shortint keys and ciphertexts.

Port of `tfhe_tpu/shortint/compressed.py` (ref: tfhe/src/shortint/
server_key/compressed.rs CompressedServerKey; shortint/ciphertext/mod.rs
CompressedCiphertext): masks are drawn from a public seeded CSPRNG
stream, so only bodies travel; decompression regenerates the masks in one
AES-CTR sweep and prepares the keys on the bodies' device.
"""

from __future__ import annotations

import numpy as np

from ..core import seeded as seeded_mod
from ..ops.torus import to_tensor
from .ciphertext import ShortintBatch
from .client_key import ClientKey
from .server_key import ServerKey


class CompressedServerKey:
    """Seeded BSK + seeded KSK (ref: shortint/server_key/compressed.rs),
    about half a ServerKey's bytes at k = 1; `decompress()` gives a server
    key prepared on the device its bodies are on."""

    def __init__(self, cks: ClientKey):
        p = cks.params
        self.params = p
        self.seeded_bsk, self.seeded_ksk = \
            seeded_mod.generate_seeded_server_key_material(
                cks.lwe_sk, cks.glwe_sk, p.pbs_base_log, p.pbs_level,
                p.glwe_modular_std_dev, cks.big_sk, p.ks_base_log,
                p.ks_level, p.lwe_modular_std_dev, cks._seeder)

    @classmethod
    def _from_state(cls, meta: dict, arrays: dict,
                    device) -> "CompressedServerKey":
        from ..utils.serialization import _params_from_meta

        self = cls.__new__(cls)
        self.params = _params_from_meta(meta["params"])
        p = self.params
        self.seeded_bsk = seeded_mod.SeededBootstrapKey(
            bodies=to_tensor(arrays["bsk_bodies"], device),
            mask_seed=int(meta["bsk_mask_seed"]),
            glwe_dimension=p.glwe_dimension, base_log=p.pbs_base_log,
            bits=p.torus_bits)
        self.seeded_ksk = seeded_mod.SeededKeyswitchKey(
            bodies=to_tensor(arrays["ksk_bodies"], device),
            mask_seed=int(meta["ksk_mask_seed"]), out_dim=p.lwe_dimension,
            base_log=p.ks_base_log, bits=p.torus_bits)
        return self

    def decompress(self) -> ServerKey:
        bsk = seeded_mod.decompress_bootstrap_key(self.seeded_bsk)
        ksk = seeded_mod.decompress_keyswitch_key(self.seeded_ksk)
        return ServerKey.from_raw(self.params, bsk, ksk, device=bsk.device)


class CompressedCiphertextList:
    """A seeded batch of fresh shortint encryptions (ref: shortint/
    ciphertext/mod.rs CompressedCiphertext, as a list)."""

    def __init__(self, seeded: seeded_mod.SeededLweBatch,
                 degrees: np.ndarray, message_modulus: int,
                 carry_modulus: int):
        self.seeded = seeded
        self.degrees = np.asarray(degrees, dtype=np.int64)
        self.message_modulus = message_modulus
        self.carry_modulus = carry_modulus

    def decompress(self) -> ShortintBatch:
        return ShortintBatch(
            data=seeded_mod.decompress_seeded_lwe(self.seeded),
            degrees=self.degrees.copy(),
            message_modulus=self.message_modulus,
            carry_modulus=self.carry_modulus)

    def _conformance_check(self, params) -> None:
        from ..utils.serialization import ConformanceError

        if (self.message_modulus != params.message_modulus
                or self.carry_modulus != params.carry_modulus):
            raise ConformanceError(
                f"modulus mismatch: ({self.message_modulus},"
                f"{self.carry_modulus}) != params "
                f"({params.message_modulus},{params.carry_modulus})")
        if self.seeded.lwe_dimension + 1 != params.ciphertext_lwe_size:
            raise ConformanceError(
                f"LWE dimension mismatch: {self.seeded.lwe_dimension} != "
                f"params {params.ciphertext_lwe_size - 1}")


def encrypt_compressed_batch(cks: ClientKey,
                             messages) -> CompressedCiphertextList:
    """Client-side seeded encryption of a message batch
    (ref: shortint/client_key/mod.rs encrypt_compressed)."""
    p = cks.params
    messages = np.asarray(messages, dtype=np.uint64)
    encoded = (messages % np.uint64(p.total_modulus)) * np.uint64(p.delta)
    sk, std = cks.encryption_key_and_noise
    mask_seed = cks._seeder.seed()
    seeded = seeded_mod.encrypt_seeded_lwe(sk, encoded, std, mask_seed,
                                           cks.enc_gen)
    return CompressedCiphertextList(
        seeded=seeded,
        degrees=np.minimum(messages.astype(np.int64), p.total_modulus - 1),
        message_modulus=p.message_modulus, carry_modulus=p.carry_modulus)
