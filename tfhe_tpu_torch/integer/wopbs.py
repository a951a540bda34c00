"""Integer (radix) WoPBS: an arbitrary function of a whole radix integer,
one vertical-packing lookup per output block.

Port of `tfhe_tpu/integer/wopbs.py` (ref: tfhe/src/integer/wopbs/mod.rs:
277-340 wopbs + generate_lut — bits are extracted per block, MSB block
first, circuit-bootstrapped once and shared by every output block's
vertical packing).
"""

from __future__ import annotations

import math
from typing import Callable, List

import numpy as np
import torch

from ..core import wopbs as wop
from ..shortint.ciphertext import ShortintBatch
from ..shortint.wopbs import WopbsKey
from .ciphertext import RadixCiphertext


class IntegerWopbsLUT:
    """One LUT polynomial list [count, N] uint64 per output block
    (ref: integer/wopbs/mod.rs IntegerWopbsLUT)."""

    def __init__(self, polys_per_block: List[np.ndarray],
                 message_modulus: int):
        self.polys_per_block = polys_per_block
        self.message_modulus = message_modulus


class IntegerWopbsKey:
    def __init__(self, wopbs_key: WopbsKey):
        self.key = wopbs_key
        self.params = wopbs_key.params

    def _bits_per_block(self, degrees) -> int:
        deg = int(np.max(degrees))
        return max(1, math.ceil(math.log2(deg + 1)))

    def generate_lut(self, ct: RadixCiphertext,
                     f: Callable[[int], int]) -> IntegerWopbsLUT:
        """LUT indexed by the packed extracted bits of `ct` (MSB block
        first: the plain integer value for a power-of-two radix)
        (ref: integer/wopbs/mod.rs generate_lut)."""
        p = self.params
        msg = p.message_modulus
        nb = ct.num_blocks
        total_bits = self._bits_per_block(ct.blocks.degrees) * nb
        N = p.polynomial_size
        count = max(1, (1 << total_bits) // N)
        delta_log = p.delta.bit_length() - 1
        modulus = msg ** nb
        polys = []
        for j in range(nb):
            poly = np.zeros((count, N), dtype=np.uint64)
            for v in range(1 << total_bits):
                out = int(f(v % modulus)) % modulus
                block_val = (out // msg ** j) % msg
                poly[v // N, v % N] = np.uint64(block_val) << np.uint64(
                    delta_log)
            polys.append(poly)
        return IntegerWopbsLUT(polys, msg)

    def wopbs(self, ct: RadixCiphertext,
              lut: IntegerWopbsLUT) -> RadixCiphertext:
        """(ref: integer/wopbs/mod.rs:277-340)"""
        p = self.params
        wk = self.key
        nb = ct.num_blocks
        bits_pb = self._bits_per_block(ct.blocks.degrees)
        delta_log = p.delta.bit_length() - 1

        # one batched extraction over all blocks, reordered to the
        # MSB-block-first, MSB-bit-first list the packing expects
        bits = wk.extract_bits_batch(ct.blocks, delta_log, bits_pb)
        ordered = bits.flip(0).reshape(nb * bits_pb, -1)
        # one batched circuit bootstrap over every extracted bit
        ggsw_all = wk.cbs.circuit_bootstrap(ordered, 63)
        ggsw_list = [ggsw_all[i:i + 1] for i in range(nb * bits_pb)]
        out_blocks = [
            wop.vertical_packing(lut.polys_per_block[j], ggsw_list,
                                 p.glwe_size, p.cbs_base_log,
                                 p.cbs_level)[0]
            for j in range(nb)]
        return RadixCiphertext(ShortintBatch(
            data=torch.stack(out_blocks),
            degrees=np.full(nb, p.message_modulus - 1, dtype=np.int64),
            message_modulus=p.message_modulus,
            carry_modulus=p.carry_modulus))
