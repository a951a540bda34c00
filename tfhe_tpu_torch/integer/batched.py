"""Batched radix ops: B radix integers at once, one keyswitch + PBS wave
per PBS round.

Port of `tfhe_tpu/integer/batched.py:35-309`, the eager front of the
clean-block chains of `integer/fused.py`: an op is its chain (`_radix_op`)
over a [B, nb, lwe_size] grid of clean block words (int64 torus tensors on
the key's device), every wave one call of the shortint key's `_pbs_device`
over all B*nb (or B) rows, its bivariate LUTs in the packed form of the
reference's waves (`fused._lut`).  No degree or noise is tracked: the
inputs are clean (degree < message_modulus) and each schedule is fixed.

The carry schedule of add, sub, neg and mul is an argument: "scan" or
"ripple", anything else raises.  The reference reads it from
TFHE_TPU_CARRY_MODE, falls back to the scan on an unknown value, and
resolves "auto" with a TPU cost model; the port has no automatic choice
until a card measurement can make one.

Each public op is a span `schedule.batched.<op>` (`utils.profiling`), its
waves `core.pbs` spans inside it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.profiling import spanned
from . import fused as F

CARRY_MODES = ("scan", "ripple")


class BatchedRadixOps:
    """Batched radix arithmetic over block grids [B, nb, lwe_size] of CLEAN
    radix blocks (degree < message_modulus), least significant first: the
    layout RadixCiphertext.blocks.data stacks to.

    mode: the carry propagation's schedule, "scan" (Hillis-Steele over
    3-state blocks: 3 + log2(nb) waves, each B*nb wide; the lower latency)
    or "ripple" (one B-wide carry wave per block, then one B*nb-wide
    message extract: about 2 PBS a block in place of 3 + log2(nb), so fewer
    PBS where throughput binds)."""

    def __init__(self, sks, mode: str):
        if mode not in CARRY_MODES:
            raise ValueError(f"unknown carry schedule {mode!r}; expected one "
                             f"of {CARRY_MODES}")
        self.sks = sks  # shortint ServerKey
        self.mode = mode
        self._fns: dict = {}  # (op, nb) -> its bound chain

    def _pbs(self, rows: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
        # looked up at every wave: a wrapper installed on the key, or on
        # its class, sees each one
        return self.sks._pbs_device(rows, acc)

    def _run(self, op: str, *args):
        key = (op, args[-1].shape[1])
        fn = self._fns.get(key)
        if fn is None:
            fn = self._fns[key] = F._radix_op(
                self.sks, op, key[1], self._pbs, packed=True, carry=self.mode)
        return fn(*args)

    @spanned("schedule.batched.add")
    def add(self, a, b):
        return self._run("add", a, b)

    @spanned("schedule.batched.sub")
    def sub(self, a, b):
        return self._run("sub", a, b)

    @spanned("schedule.batched.neg")
    def neg(self, a):
        return self._run("neg", a)

    @spanned("schedule.batched.mul")
    def mul(self, a, b):
        """Carry-save block-product multiplication (ref: radix_parallel/
        mul.rs:329-464 and the add.rs:789 sum trees)."""
        return self._run("mul", a, b)

    @spanned("schedule.batched.eq")
    def eq(self, a, b):
        """[B, nb, sz] x2 -> [B, sz] 0/1 boolean blocks, sum-packed."""
        return self._run("eq", a, b)

    @spanned("schedule.batched.ne")
    def ne(self, a, b):
        return self._run("ne", a, b)

    @spanned("schedule.batched.lt")
    def lt(self, a, b):
        return self._run("lt", a, b)

    @spanned("schedule.batched.le")
    def le(self, a, b):
        return self._run("le", a, b)

    @spanned("schedule.batched.gt")
    def gt(self, a, b):
        return self._run("gt", a, b)

    @spanned("schedule.batched.ge")
    def ge(self, a, b):
        return self._run("ge", a, b)


def encrypt_batch_radix(icks, values, num_blocks: int) -> torch.Tensor:
    """Clear ints -> [B, nb, sz] block words for BatchedRadixOps, on the
    client key's device."""
    msg = icks.message_modulus
    digs = [(int(v) // msg**j) % msg
            for v in values for j in range(num_blocks)]
    data = icks.key.encrypt_batch(np.asarray(digs, np.uint64)).data
    return data.reshape(len(values), num_blocks, -1)


def decrypt_batch_radix(icks, data: torch.Tensor) -> list:
    """[B, nb, sz] -> clear ints (mod msg**nb)."""
    B, nb, sz = data.shape
    msg = icks.message_modulus
    digs = icks.key.decrypt_batch(data.reshape(-1, sz)).reshape(B, nb)
    return [int(sum(int(d) * msg**j for j, d in enumerate(row)))
            for row in digs]
