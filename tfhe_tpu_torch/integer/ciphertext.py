"""Radix ciphertexts: big integers as vectors of shortint blocks, least
significant first.

Port of `tfhe_tpu/integer/ciphertext.py` (ref: tfhe/src/integer/ciphertext/
mod.rs:18-30) over the port's `ShortintBatch`: the blocks' LWE data is one
int64 tensor [num_blocks, lwe_size] on the key's device, their degrees and
noise levels numpy bookkeeping.  `_conformance_check` delegates to the
blocks' (`ShortintBatch._conformance_check`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..shortint.ciphertext import ShortintBatch


@dataclass
class RadixCiphertext:
    """blocks: a ShortintBatch of num_blocks blocks, least significant
    first."""

    blocks: ShortintBatch

    @property
    def num_blocks(self) -> int:
        return len(self.blocks)

    def copy(self) -> "RadixCiphertext":
        return RadixCiphertext(self.blocks.copy())

    def block_degrees(self) -> np.ndarray:
        return self.blocks.degrees

    def _conformance_check(self, params) -> None:
        self.blocks._conformance_check(params)


@dataclass
class BooleanBlock:
    """A single block known to hold 0/1 (ref: integer/ciphertext/
    boolean_value.rs)."""

    block: ShortintBatch  # a batch of one block

    def copy(self) -> "BooleanBlock":
        return BooleanBlock(self.block.copy())

    def _conformance_check(self, params) -> None:
        self.block._conformance_check(params)
