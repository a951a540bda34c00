"""Encrypted ASCII strings (port of `tfhe_tpu/strings/ciphertext.py`; ref:
tfhe/examples/fhe_strings/ciphertext.rs).

FheString = {content: [FheAsciiChar], padding, length: clear | encrypted}.
Padding zeros hide the true length and are dropped on decryption.  Each
char is a radix ciphertext of its ASCII code, its blocks on the key's
device.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import List, Union

from ..integer.ciphertext import RadixCiphertext


class Padding(enum.IntEnum):
    """(ref: ciphertext.rs:20-44; ordered least to most inconvenient)"""

    NONE = 0
    FINAL = 1
    INITIAL = 2
    INITIAL_AND_FINAL = 3
    ANYWHERE = 4


# a length is a clear int or an encrypted radix integer
FheStrLength = Union[int, RadixCiphertext]


@dataclass
class FheAsciiChar:
    ct: RadixCiphertext


@dataclass
class FheSplit:
    """The result of the split ops (ref: split.rs:13-17).  Only the first
    `number_parts` entries of `parts` are meaningful; the consumer ignores
    the rest."""

    parts: List["FheString"]
    number_parts: Union[int, RadixCiphertext]
    current_index: int = 0


@dataclass
class FheString:
    content: List[FheAsciiChar]
    padding: Padding
    length: FheStrLength

    @property
    def max_len(self) -> int:
        return len(self.content)

    def is_encrypted_length(self) -> bool:
        return isinstance(self.length, RadixCiphertext)

    def copy(self) -> "FheString":
        return FheString(
            content=[FheAsciiChar(c.ct.copy()) for c in self.content],
            padding=self.padding,
            length=(self.length if isinstance(self.length, int)
                    else self.length.copy()))
