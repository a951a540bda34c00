"""Radix client key (port of `tfhe_tpu/integer/client_key.py`; ref:
tfhe/src/integer/client_key/mod.rs, gen_keys_radix integer/mod.rs:171).

Values are Python ints, split into blocks and recombined in Python ints, so
a radix of 32 blocks of 2 bits (modulus 2^64) holds every value below 2^64:
no block value passes through an int64."""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..params import ClassicPBSParameters
from ..shortint import ClientKey as ShortintClientKey
from .ciphertext import BooleanBlock, RadixCiphertext
from .signed import SignedRadixCiphertext


class RadixClientKey:
    """A shortint client key and a default block count; on `device` (the
    card unless the caller passes "cpu")."""

    def __init__(self, params: ClassicPBSParameters, num_blocks: int,
                 seed: Optional[int] = None, device="cuda", _key=None):
        self.key = _key if _key is not None else ShortintClientKey(
            params, seed=seed, device=device)
        self.num_blocks = num_blocks
        self.params = params

    @property
    def message_modulus(self) -> int:
        return self.params.message_modulus

    def modulus(self, num_blocks: Optional[int] = None) -> int:
        return self.message_modulus ** (num_blocks or self.num_blocks)

    def _to_blocks(self, value: int, num_blocks: int) -> np.ndarray:
        msg = self.message_modulus
        value = int(value) % self.modulus(num_blocks)
        return np.array([(value // msg**i) % msg for i in range(num_blocks)],
                        dtype=np.uint64)

    def encrypt(self, value: int,
                num_blocks: Optional[int] = None) -> RadixCiphertext:
        nb = num_blocks or self.num_blocks
        return RadixCiphertext(self.key.encrypt_batch(
            self._to_blocks(value, nb)))

    def decrypt(self, ct: RadixCiphertext) -> int:
        msg = self.message_modulus
        blocks = self.key.decrypt_batch(ct.blocks)
        return sum(int(b) * msg**i for i, b in enumerate(blocks)) % \
            self.modulus(ct.num_blocks)

    def encrypt_signed(self, value: int, num_blocks: Optional[int] = None
                       ) -> SignedRadixCiphertext:
        """Two's complement encoding (ref: integer/client_key signed)."""
        nb = num_blocks or self.num_blocks
        return SignedRadixCiphertext(
            self.key.encrypt_batch(self._to_blocks(value, nb)))

    def decrypt_signed(self, ct: RadixCiphertext) -> int:
        v = self.decrypt(ct)
        mod = self.modulus(ct.num_blocks)
        return v - mod if v >= mod // 2 else v

    def decrypt_bool(self, b: BooleanBlock) -> bool:
        return bool(self.key.decrypt_batch(b.block)[0])

    def encrypt_bool(self, value: bool) -> BooleanBlock:
        return BooleanBlock(self.key.encrypt_batch(
            np.asarray([int(value)], dtype=np.uint64)))
