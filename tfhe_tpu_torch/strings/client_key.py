"""String client key (port of `tfhe_tpu/strings/client_key.py`; ref:
tfhe/examples/fhe_strings/client_key.rs)."""

from __future__ import annotations

import random
from typing import Optional

from ..integer import RadixClientKey
from .ciphertext import FheAsciiChar, FheString, Padding

# 8-bit chars in 2-bit message blocks (ref: ciphertext.rs:14)
NUMBER_BLOCKS = 4


class ConversionError(Exception):
    pass


class StringClientKey:
    def __init__(self, integer_key: RadixClientKey):
        self.integer_key = integer_key

    def _check_ascii(self, data: bytes):
        if any(c > 127 for c in data):
            raise ConversionError("NonAsciiCharacters")

    def encrypt_ascii_vec(self, ascii_vec, padding: Padding,
                          length) -> FheString:
        self._check_ascii(bytes(ascii_vec))
        content = [
            FheAsciiChar(self.integer_key.encrypt(b, num_blocks=NUMBER_BLOCKS))
            for b in ascii_vec]
        return FheString(content=content, padding=padding, length=length)

    def encrypt_str(self, s: str) -> FheString:
        """(ref: client_key.rs:28 encrypt_str)"""
        return self.encrypt_ascii_vec(s.encode("ascii"), Padding.NONE, len(s))

    def encrypt_str_padding(self, s: str, padding_size: int) -> FheString:
        """padding_size encrypted zeros appended; the length is encrypted
        (ref: client_key.rs encrypt_str_padding)."""
        if padding_size == 0:
            return self.encrypt_str(s)
        data = s.encode("ascii") + b"\x00" * padding_size
        return self.encrypt_ascii_vec(
            data, Padding.FINAL,
            self.integer_key.encrypt(len(s), num_blocks=NUMBER_BLOCKS))

    def encrypt_str_random_padding(self, s: str, padding_size: int,
                                   rng: Optional[random.Random] = None
                                   ) -> FheString:
        """Padding zeros at random places (ref: client_key.rs); without an
        rng, `random.Random(0)` places them, as in the reference."""
        if padding_size == 0:
            return self.encrypt_str(s)
        rng = rng or random.Random(0)
        chars = list(s.encode("ascii"))
        for _ in range(padding_size):
            chars.insert(rng.randint(0, len(chars)), 0)
        return self.encrypt_ascii_vec(
            bytes(chars), Padding.ANYWHERE,
            self.integer_key.encrypt(len(s), num_blocks=NUMBER_BLOCKS))

    def decrypt_string(self, s: FheString) -> str:
        """Padding zeros are dropped (ref: client_key.rs:77)."""
        out = []
        for ch in s.content:
            v = self.integer_key.decrypt(ch.ct)
            if v != 0:
                out.append(chr(v))
        return "".join(out)

    def decrypt_split(self, sp) -> list:
        """The first number_parts parts, decrypted (ref: split.rs:9-17)."""
        k = sp.number_parts
        if not isinstance(k, int):
            k = self.integer_key.decrypt(k)
        return [self.decrypt_string(p) for p in sp.parts[:k]]

    def decrypt_ascii_char(self, ch: FheAsciiChar) -> int:
        return self.integer_key.decrypt(ch.ct)

    def encrypt_ascii_char(self, c: int) -> FheAsciiChar:
        return FheAsciiChar(self.integer_key.encrypt(c,
                                                     num_blocks=NUMBER_BLOCKS))
