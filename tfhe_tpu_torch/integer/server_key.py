"""Radix integer server key: the reference's radix ops as schedules of
batched PBS over the port's shortint batch calls.

Port of `tfhe_tpu/integer/server_key.py` (ref: tfhe/src/integer/server_key/
radix_parallel/), host path only: every op makes the same PBS batches, of
the same sizes and in the same order, as the reference's host path, so its
outputs equal the reference's word for word.  Where the reference fans out
rayon tasks over independent per-block PBS, every round is ONE shortint
batch call over all blocks (on a card: one keyswitch and one blind
rotation on the kernels of `ops/fused_pbs.py`, in the key's `mode`); the
Hillis-Steele parallel-prefix carry propagation (radix_parallel/
add.rs:572-603) is a log2(n)-round batched bivariate-PBS scan.

`IntegerServerKey(key, fused=True)` sends the ops at the reference's hook
points (`tfhe_tpu/integer/server_key.py:213-555`) to the single-program
schedule of `fused_dispatch` first (the reference chooses it by the
environment variable TFHE_TPU_FUSED_INTEGER); an op whose inputs are not
clean takes the host schedule there, as in the reference.  Block data
stays in one tensor on the key's device: blocks are cut with views, joined
with `torch.cat` and gathered with one index tensor per gather; degrees and
noise levels are numpy bookkeeping, so no op reads a block back to the host.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..shortint import ServerKey as ShortintServerKey
from ..shortint.ciphertext import ShortintBatch
from ..shortint.server_key import BivariateLookupTable
from . import fused as F
from .ciphertext import BooleanBlock, RadixCiphertext
from .signed import SignedOps, SignedRadixCiphertext

_U64 = np.uint64


def _concat(batches: Sequence[ShortintBatch]) -> ShortintBatch:
    return ShortintBatch(
        data=torch.cat([b.data for b in batches]),
        degrees=np.concatenate([b.degrees for b in batches]),
        message_modulus=batches[0].message_modulus,
        carry_modulus=batches[0].carry_modulus,
        noise=np.concatenate([b.noise for b in batches]))


def _slice(b: ShortintBatch, lo: int, hi: int) -> ShortintBatch:
    return ShortintBatch(
        data=b.data[lo:hi], degrees=b.degrees[lo:hi],
        message_modulus=b.message_modulus, carry_modulus=b.carry_modulus,
        noise=b.noise[lo:hi])


def _gather(b: ShortintBatch, rows) -> ShortintBatch:
    """Blocks `rows` of b (any order, repeats allowed): one index tensor on
    b's device."""
    rows = np.asarray(rows, dtype=np.int64)
    index = torch.from_numpy(rows).to(b.data.device)
    return ShortintBatch(
        data=b.data[index], degrees=b.degrees[rows],
        message_modulus=b.message_modulus, carry_modulus=b.carry_modulus,
        noise=b.noise[rows])


class IntegerServerKey(SignedOps):
    """`fused` picks the radix ops' schedule: False (the default) the host
    schedule, every op its reference's host path; True the single-program
    ops of `fused_dispatch` for clean inputs (one CUDA graph replay per op
    on a card), the host schedule for the others."""

    def __init__(self, key: ShortintServerKey, fused: bool = False):
        self.key = key
        self.message_modulus = key.message_modulus
        self.fused = fused
        self._fused_ops = None

    def _fused(self, op: str, *batches) -> Optional[ShortintBatch]:
        """`op` in the single-program schedule over clean blocks, or None:
        the host schedule (fused=False, or blocks that are not clean)."""
        if not self.fused:
            return None
        if self._fused_ops is None:
            from .fused_dispatch import FusedIntegerOps
            self._fused_ops = FusedIntegerOps(self)
        return self._fused_ops.try_op(op, *batches)

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    @property
    def _msg(self) -> int:
        return self.message_modulus

    def _zeros(self, n: int) -> ShortintBatch:
        return self.key.trivial_batch(np.zeros(n, dtype=_U64), n)

    def create_trivial_radix(self, value: int,
                             num_blocks: int) -> RadixCiphertext:
        msg = self._msg
        value = int(value) % msg ** num_blocks
        digits = np.array([(value // msg**i) % msg for i in range(num_blocks)],
                          dtype=_U64)
        return RadixCiphertext(self.key.trivial_batch(digits, num_blocks))

    def create_trivial_bool(self, value: bool) -> BooleanBlock:
        return BooleanBlock(self.key.trivial_batch(
            np.asarray([int(value)], dtype=_U64), 1))

    def _shift_blocks_up(self, b: ShortintBatch, d: int, num: int = 1
                         ) -> ShortintBatch:
        """towards higher significance: new[i] = old[i-d], zeros below."""
        nb = len(b) // num
        if d == 0:
            return b.copy()
        parts = []
        for g in range(num):
            blk = _slice(b, g * nb, (g + 1) * nb)
            parts.append(_concat([self._zeros(min(d, nb)),
                                  _slice(blk, 0, max(nb - d, 0))]))
        return _concat(parts)

    def _shift_blocks_down(self, b: ShortintBatch, d: int, num: int = 1
                           ) -> ShortintBatch:
        nb = len(b) // num
        if d == 0:
            return b.copy()
        parts = []
        for g in range(num):
            blk = _slice(b, g * nb, (g + 1) * nb)
            parts.append(_concat([_slice(blk, min(d, nb), nb),
                                  self._zeros(min(d, nb))]))
        return _concat(parts)

    # ------------------------------------------------------------------
    # carry propagation (Hillis-Steele prefix scan over batched PBS)
    # (ref: radix_parallel/add.rs:518-603 low-latency propagation)
    # ------------------------------------------------------------------

    def propagate_single_carry(self, b: ShortintBatch, num: int = 1
                               ) -> Tuple[ShortintBatch, ShortintBatch]:
        """Blocks hold v_i with carry <= 1; returns (clean blocks, carry-outs).

        Requires degrees <= 2*msg-2 (block 0 of each group may be 2*msg-1
        since it receives no carry-in).  carry-outs is the resolved state of
        the top block of each group mapped to 0/1.
        """
        msg = self._msg
        if msg < 4:
            # the 3-state resolve needs packing room for states {0,1,2}
            # against factor=msg; small-message sets (PARAM_MESSAGE_1_CARRY_1)
            # propagate sequentially instead (ref: the radix/mod.rs
            # sequential propagate path used by non-parallel ops)
            return self._sequential_propagate(b, num=num)
        sks = self.key
        nb = len(b) // num
        state = sks.apply_lookup_table_batch(b, F._lut(sks, "state"))
        resolve = BivariateLookupTable(acc=F._lut(sks, "resolve"), factor=msg)
        d = 1
        while d < nb:
            prev = self._shift_blocks_up(state, d, num=num)
            state = sks.unchecked_bivariate_batch(state, prev, resolve)
            d *= 2
        carries = sks.apply_lookup_table_batch(state, F._lut(sks, "carry"))
        carry_in = self._shift_blocks_up(carries, 1, num=num)
        s = sks.unchecked_add_batch(b, carry_in)
        clean = sks.message_extract_batch(s)
        # carry out of each group = carries at the top block
        carry_out = _gather(carries, [g * nb + nb - 1 for g in range(num)])
        return clean, carry_out

    def _sequential_propagate(self, b: ShortintBatch, num: int = 1
                              ) -> Tuple[ShortintBatch, ShortintBatch]:
        """Carry chain one block at a time, batched across the `num` groups.

        Works for every parameter set incl. msg < 4 as long as each block's
        degree + 1 fits the total modulus (degrees <= 2*msg - 2 guarantees
        it: 2*msg - 2 + 1 < msg * carry for carry >= 2).
        """
        sks = self.key
        nb = len(b) // num
        # view as [num, nb]; process block index i across all groups at once
        idx = np.arange(num) * nb
        carry = sks.trivial_batch(np.zeros(num, dtype=np.int64), num)
        clean_parts = []
        for i in range(nb):
            s = sks.unchecked_add_batch(_gather(b, idx + i), carry)
            clean_parts.append(sks.message_extract_batch(s))
            carry = sks.carry_extract_batch(s)
        data = torch.stack([c.data for c in clean_parts], dim=1)
        degs = np.stack([c.degrees for c in clean_parts], axis=1)
        noi = np.stack([c.noise for c in clean_parts], axis=1)
        clean = ShortintBatch(
            data=data.reshape(num * nb, -1), degrees=degs.reshape(-1),
            message_modulus=b.message_modulus, carry_modulus=b.carry_modulus,
            noise=noi.reshape(-1))
        return clean, carry

    def full_propagate(self, b: ShortintBatch, num: int = 1) -> ShortintBatch:
        """Clean blocks of any degree < total_modulus
        (ref: server_key/radix/mod.rs:503-565 full_propagate)."""
        msg = self._msg
        while int(b.degrees.max(initial=0)) >= msg:
            m = self.key.message_extract_batch(b)
            c = self.key.carry_extract_batch(b)
            cin = self._shift_blocks_up(c, 1, num=num)
            b = self.key.unchecked_add_batch(m, cin)
            if int(b.degrees.max(initial=0)) <= 2 * msg - 2:
                clean, _ = self.propagate_single_carry(b, num=num)
                return clean
        return b

    # ------------------------------------------------------------------
    # add / sub / neg
    # ------------------------------------------------------------------

    def add_parallelized(self, a: RadixCiphertext, b: RadixCiphertext
                         ) -> RadixCiphertext:
        r = self._fused("add", a.blocks, b.blocks)
        if r is not None:
            return RadixCiphertext(r)
        s = self.key.unchecked_add_batch(a.blocks, b.blocks)
        clean, _ = self.propagate_single_carry(s)
        return RadixCiphertext(clean)

    def _neg_blocks(self, b: ShortintBatch, num: int = 1) -> ShortintBatch:
        """Per-block negation with borrow-absorbing correcting terms
        (ref: integer/server_key/radix/neg.rs)."""
        msg = self._msg
        nb = len(b) // num
        degrees = np.zeros_like(b.degrees)
        terms = np.zeros(len(b), dtype=np.int64)
        for g in range(num):
            cc = 0  # correction carried into this block
            for i in range(nb):
                idx = g * nb + i
                z = max(-(-(int(b.degrees[idx]) + cc) // msg), 1) * msg
                terms[idx] = (z - cc) % (2 * msg * b.carry_modulus)
                degrees[idx] = z - cc
                cc = z // msg
        data = 0 - b.data
        data[:, -1] += self.key._body_addend(terms)
        return ShortintBatch(
            data=data, degrees=degrees, message_modulus=b.message_modulus,
            carry_modulus=b.carry_modulus, noise=b.noise.copy())

    def neg_parallelized(self, a: RadixCiphertext) -> RadixCiphertext:
        r = self._fused("neg", a.blocks)
        if r is not None:
            return RadixCiphertext(r)
        clean, _ = self.propagate_single_carry(self._neg_blocks(a.blocks))
        return RadixCiphertext(clean)

    def sub_parallelized(self, a: RadixCiphertext, b: RadixCiphertext
                         ) -> RadixCiphertext:
        r = self._fused("sub", a.blocks, b.blocks)
        if r is not None:
            return RadixCiphertext(r)
        nbk = self._neg_blocks(b.blocks)
        s = self.key.unchecked_add_batch(a.blocks, nbk)
        clean, _ = self.propagate_single_carry(s)
        return RadixCiphertext(clean)

    # ------------------------------------------------------------------
    # scalar add / sub / mul
    # ------------------------------------------------------------------

    def scalar_add_parallelized(self, a: RadixCiphertext, scalar: int
                                ) -> RadixCiphertext:
        t = self.create_trivial_radix(scalar, a.num_blocks)
        return self.add_parallelized(a, t)

    def scalar_sub_parallelized(self, a: RadixCiphertext, scalar: int
                                ) -> RadixCiphertext:
        msg = self._msg
        return self.scalar_add_parallelized(a, -scalar % msg ** a.num_blocks)

    def scalar_mul_parallelized(self, a: RadixCiphertext, scalar: int
                                ) -> RadixCiphertext:
        """Clear-digit partial products, one PBS batch for the low and one
        for the high halves, then the column sum (ref:
        radix_parallel/scalar_mul.rs)."""
        msg = self._msg
        nb = a.num_blocks
        scalar = int(scalar) % msg ** nb
        if scalar == 0:
            return self.create_trivial_radix(0, nb)
        if scalar == 1:
            return RadixCiphertext(self.full_propagate(a.blocks.copy()))
        digits = [(scalar // msg**j) % msg for j in range(nb)]
        sks = self.key
        columns: List[List[ShortintBatch]] = [[] for _ in range(nb)]
        # every (digit j, block i, lsb/msb) partial product in 2 calls
        lsb_luts, msb_luts, lsb_idx, msb_idx = [], [], [], []
        for j, dgt in enumerate(digits):
            if dgt == 0:
                continue
            for i in range(nb - j):
                lsb_luts.append(sks.generate_lookup_table(
                    lambda x, s=dgt: ((x % msg) * s) % msg))
                lsb_idx.append((i, j))
                if i + j + 1 < nb and dgt * (msg - 1) >= msg:
                    msb_luts.append(sks.generate_lookup_table(
                        lambda x, s=dgt: ((x % msg) * s) // msg))
                    msb_idx.append((i, j))
        for luts, idxs, off in ((lsb_luts, lsb_idx, 0),
                                (msb_luts, msb_idx, 1)):
            if not idxs:
                continue
            src = _gather(a.blocks, [i for (i, j) in idxs])
            out = sks.apply_many_lookup_tables_batch(
                src, luts, np.arange(len(luts)))
            for t, (i, j) in enumerate(idxs):
                columns[i + j + off].append(_slice(out, t, t + 1))
        return RadixCiphertext(self._sum_columns(columns))

    # ------------------------------------------------------------------
    # multiplication (ref: radix_parallel/mul.rs:329-464 block products +
    # add.rs:789 carry-save sum tree)
    # ------------------------------------------------------------------

    def mul_parallelized(self, a: RadixCiphertext, b: RadixCiphertext
                         ) -> RadixCiphertext:
        r = self._fused("mul", a.blocks, b.blocks)
        if r is not None:
            return RadixCiphertext(r)
        msg = self._msg
        sks = self.key
        nb = a.num_blocks
        lsb = sks.generate_lookup_table_bivariate(lambda x, y: (x * y) % msg)
        msb = sks.generate_lookup_table_bivariate(lambda x, y: (x * y) // msg)
        pairs_lsb = [(i, j) for j in range(nb) for i in range(nb - j)]
        pairs_msb = [(i, j) for j in range(nb) for i in range(nb - j)
                     if i + j + 1 < nb]
        columns: List[List[ShortintBatch]] = [[] for _ in range(nb)]
        for pairs, blut, off in ((pairs_lsb, lsb, 0), (pairs_msb, msb, 1)):
            if not pairs:
                continue
            av = _gather(a.blocks, [i for i, _ in pairs])
            bv = _gather(b.blocks, [j for _, j in pairs])
            out = sks.unchecked_bivariate_batch(av, bv, blut)
            for t, (i, j) in enumerate(pairs):
                columns[i + j + off].append(_slice(out, t, t + 1))
        return RadixCiphertext(self._sum_columns(columns))

    def _sum_columns(self, columns: List[List[ShortintBatch]]
                     ) -> ShortintBatch:
        """Carry-save reduction of per-position block lists to one clean
        radix."""
        msg = self._msg
        sks = self.key
        nb = len(columns)
        chunk = max(sks.max_degree // (msg - 1), 2)
        while True:
            counts = [len(c) for c in columns]
            if all(c <= 1 for c in counts):
                break
            if max(counts) <= 2:
                # two addends left: one add + carry propagation
                top = [c[0] if len(c) > 0 else self._zeros(1) for c in columns]
                bot = [c[1] if len(c) > 1 else self._zeros(1) for c in columns]
                s = sks.unchecked_add_batch(_concat(top), _concat(bot))
                clean, _ = self.propagate_single_carry(s)
                return clean
            # chunked pure-add pass, then batched msg/carry extraction
            new_columns: List[List[ShortintBatch]] = [[] for _ in range(nb)]
            to_extract: List[Tuple[int, ShortintBatch]] = []
            for p, col in enumerate(columns):
                for lo in range(0, len(col), chunk):
                    part = col[lo:lo + chunk]
                    acc = part[0]
                    for other in part[1:]:
                        acc = sks.unchecked_add_batch(acc, other)
                    if len(part) == 1 and int(acc.degrees.max()) < msg:
                        new_columns[p].append(acc)
                    else:
                        to_extract.append((p, acc))
            if to_extract:
                stacked = _concat([t[1] for t in to_extract])
                msgs = sks.message_extract_batch(stacked)
                carries = sks.carry_extract_batch(stacked)
                for t, (p, _) in enumerate(to_extract):
                    new_columns[p].append(_slice(msgs, t, t + 1))
                    if p + 1 < nb:
                        new_columns[p + 1].append(_slice(carries, t, t + 1))
            columns = new_columns
        return _concat([c[0] if c else self._zeros(1) for c in columns])

    # ------------------------------------------------------------------
    # bitwise (ref: radix_parallel/bitwise_op.rs)
    # ------------------------------------------------------------------

    def _blockwise_bivariate(self, a, b, f) -> RadixCiphertext:
        blut = self.key.generate_lookup_table_bivariate(f)
        return RadixCiphertext(
            self.key.unchecked_bivariate_batch(a.blocks, b.blocks, blut))

    def bitand_parallelized(self, a, b):
        r = self._fused("band", a.blocks, b.blocks)
        if r is not None:
            return RadixCiphertext(r)
        return self._blockwise_bivariate(a, b, lambda x, y: x & y)

    def bitor_parallelized(self, a, b):
        r = self._fused("bor", a.blocks, b.blocks)
        if r is not None:
            return RadixCiphertext(r)
        return self._blockwise_bivariate(a, b, lambda x, y: x | y)

    def bitxor_parallelized(self, a, b):
        r = self._fused("bxor", a.blocks, b.blocks)
        if r is not None:
            return RadixCiphertext(r)
        return self._blockwise_bivariate(a, b, lambda x, y: x ^ y)

    def bitnot(self, a: RadixCiphertext) -> RadixCiphertext:
        r = self._fused("bnot", a.blocks)
        if r is not None:
            return RadixCiphertext(r)
        lut = self.key.generate_lookup_table(
            lambda x: (self._msg - 1) - (x % self._msg))
        return RadixCiphertext(self.key.apply_lookup_table_batch(a.blocks,
                                                                 lut))

    # ------------------------------------------------------------------
    # comparisons (ref: integer/server_key/comparator.rs:31-60 — per-block
    # sign then MSB-first reduction tree)
    # ------------------------------------------------------------------

    def _block_signs(self, a: RadixCiphertext,
                     b: RadixCiphertext) -> ShortintBatch:
        blut = self.key.generate_lookup_table_bivariate(
            lambda x, y: 0 if x == y else (1 if x < y else 2))
        return self.key.unchecked_bivariate_batch(a.blocks, b.blocks, blut)

    def _reduce_signs(self, signs: ShortintBatch) -> ShortintBatch:
        """MSB-first: high block wins unless equal."""
        sks = self.key
        blut = sks.generate_lookup_table_bivariate(
            lambda high, low: min(low if high == 0 else high, 2))
        cur = signs
        while len(cur) > 1:
            n = len(cur)
            # pair adjacent blocks: (2i, 2i+1) with 2i+1 more significant
            lo = _gather(cur, range(0, n - 1, 2))
            hi = _gather(cur, range(1, n, 2))
            merged = sks.unchecked_bivariate_batch(hi, lo, blut)
            if n % 2 == 1:
                merged = _concat([merged, _slice(cur, n - 1, n)])
            cur = merged
        return cur

    def _compare(self, a, b) -> ShortintBatch:
        return self._reduce_signs(self._block_signs(a, b))

    def _sign_to_bool(self, sign: ShortintBatch, f) -> BooleanBlock:
        lut = self.key.generate_lookup_table(lambda x: int(f(x)))
        return BooleanBlock(self.key.apply_lookup_table_batch(sign, lut))

    def _cmp_op(self, op: str, a, b, f) -> BooleanBlock:
        r = self._fused(op, a.blocks, b.blocks)
        if r is not None:
            return BooleanBlock(r)
        return self._sign_to_bool(self._compare(a, b), f)

    def eq_parallelized(self, a, b) -> BooleanBlock:
        return self._cmp_op("eq", a, b, lambda s: s == 0)

    def ne_parallelized(self, a, b) -> BooleanBlock:
        return self._cmp_op("ne", a, b, lambda s: s != 0)

    def lt_parallelized(self, a, b) -> BooleanBlock:
        return self._cmp_op("lt", a, b, lambda s: s == 1)

    def le_parallelized(self, a, b) -> BooleanBlock:
        return self._cmp_op("le", a, b, lambda s: s != 2)

    def gt_parallelized(self, a, b) -> BooleanBlock:
        return self._cmp_op("gt", a, b, lambda s: s == 2)

    def ge_parallelized(self, a, b) -> BooleanBlock:
        return self._cmp_op("ge", a, b, lambda s: s != 1)

    def scalar_eq_parallelized(self, a: RadixCiphertext,
                               scalar: int) -> BooleanBlock:
        t = self.create_trivial_radix(scalar, a.num_blocks)
        return self.eq_parallelized(a, t)

    def scalar_cmp_parallelized(self, a: RadixCiphertext, scalar: int, op: str
                                ) -> BooleanBlock:
        t = self.create_trivial_radix(scalar, a.num_blocks)
        return getattr(self, f"{op}_parallelized")(a, t)

    # ------------------------------------------------------------------
    # selection (ref: radix_parallel/cmux.rs:27)
    # ------------------------------------------------------------------

    def if_then_else_parallelized(self, cond: BooleanBlock,
                                  a: RadixCiphertext,
                                  b: RadixCiphertext) -> RadixCiphertext:
        r = self._fused("select", cond.block, a.blocks, b.blocks)
        if r is not None:
            return RadixCiphertext(r)
        sks = self.key
        nb = a.num_blocks
        cond_rep = ShortintBatch(
            data=cond.block.data.expand(nb, -1),
            degrees=np.repeat(cond.block.degrees, nb),
            message_modulus=a.blocks.message_modulus,
            carry_modulus=a.blocks.carry_modulus,
            noise=np.repeat(cond.block.noise, nb))
        then_lut = sks.generate_lookup_table_bivariate(
            lambda c, x: x if c else 0)
        else_lut = sks.generate_lookup_table_bivariate(
            lambda c, x: 0 if c else x)
        ta = sks.unchecked_bivariate_batch(cond_rep, a.blocks, then_lut)
        tb = sks.unchecked_bivariate_batch(cond_rep, b.blocks, else_lut)
        s = sks.unchecked_add_batch(ta, tb)
        return RadixCiphertext(sks.message_extract_batch(s))

    cmux = if_then_else_parallelized

    def max_parallelized(self, a, b):
        r = self._fused("max", a.blocks, b.blocks)
        if r is not None:
            return RadixCiphertext(r)
        return self.if_then_else_parallelized(self.ge_parallelized(a, b), a, b)

    def min_parallelized(self, a, b):
        r = self._fused("min", a.blocks, b.blocks)
        if r is not None:
            return RadixCiphertext(r)
        return self.if_then_else_parallelized(self.le_parallelized(a, b), a, b)

    # ------------------------------------------------------------------
    # boolean-block algebra (used heavily by the string layer;
    # ref: integer BooleanBlock ops)
    # ------------------------------------------------------------------

    def _boolean_bivariate(self, x: BooleanBlock, y: BooleanBlock,
                           f) -> BooleanBlock:
        blut = self.key.generate_lookup_table_bivariate(
            lambda a, b: int(f(bool(a), bool(b))))
        return BooleanBlock(
            self.key.unchecked_bivariate_batch(x.block, y.block, blut))

    def boolean_bitand(self, x: BooleanBlock, y: BooleanBlock) -> BooleanBlock:
        return self._boolean_bivariate(x, y, lambda a, b: a and b)

    def boolean_bitor(self, x: BooleanBlock, y: BooleanBlock) -> BooleanBlock:
        return self._boolean_bivariate(x, y, lambda a, b: a or b)

    def boolean_bitxor(self, x: BooleanBlock, y: BooleanBlock) -> BooleanBlock:
        return self._boolean_bivariate(x, y, lambda a, b: a != b)

    def boolean_bitnot(self, x: BooleanBlock) -> BooleanBlock:
        lut = self.key.generate_lookup_table(lambda a: 1 - (a % 2))
        return BooleanBlock(self.key.apply_lookup_table_batch(x.block, lut))

    # ------------------------------------------------------------------
    # shifts and rotates by a clear amount (ref: radix_parallel/
    # scalar_shift.rs)
    # ------------------------------------------------------------------

    def _bits_per_block(self) -> int:
        return self._msg.bit_length() - 1

    def scalar_left_shift_parallelized(self, a: RadixCiphertext, shift: int
                                       ) -> RadixCiphertext:
        bpb = self._bits_per_block()
        shift %= a.num_blocks * bpb
        q, r = divmod(shift, bpb)
        blocks = self._shift_blocks_up(a.blocks, q)
        if r == 0:
            return RadixCiphertext(blocks)
        msg = self._msg
        lo = self._shift_blocks_up(blocks, 1)
        blut = self.key.generate_lookup_table_bivariate(
            lambda cur, below: ((cur << r) % msg) | (below >> (bpb - r)))
        return RadixCiphertext(
            self.key.unchecked_bivariate_batch(blocks, lo, blut))

    def scalar_right_shift_parallelized(self, a: RadixCiphertext, shift: int
                                        ) -> RadixCiphertext:
        bpb = self._bits_per_block()
        shift %= a.num_blocks * bpb
        q, r = divmod(shift, bpb)
        blocks = self._shift_blocks_down(a.blocks, q)
        if r == 0:
            return RadixCiphertext(blocks)
        msg = self._msg
        hi = self._shift_blocks_down(blocks, 1)
        blut = self.key.generate_lookup_table_bivariate(
            lambda above, cur: ((cur >> r) | ((above << (bpb - r)) % msg)))
        return RadixCiphertext(
            self.key.unchecked_bivariate_batch(hi, blocks, blut))

    def scalar_rotate_left_parallelized(self, a: RadixCiphertext, rot: int
                                        ) -> RadixCiphertext:
        nbits = a.num_blocks * self._bits_per_block()
        rot %= nbits
        if rot == 0:
            return a.copy()
        left = self.scalar_left_shift_parallelized(a, rot)
        right = self.scalar_right_shift_parallelized(a, nbits - rot)
        return self.bitor_parallelized(left, right)

    def scalar_rotate_right_parallelized(self, a: RadixCiphertext, rot: int
                                         ) -> RadixCiphertext:
        nbits = a.num_blocks * self._bits_per_block()
        return self.scalar_rotate_left_parallelized(a, (nbits - rot) % nbits)

    # ------------------------------------------------------------------
    # shifts and rotates by an ENCRYPTED amount: barrel shifter, one
    # cmux rung per bit of the amount (ref: radix_parallel/shift.rs,
    # rotate.rs — the reference's cmux ladder over rayon tasks becomes a
    # ladder of batched if_then_else rounds)
    # ------------------------------------------------------------------

    def _amount_bits(self, amount: RadixCiphertext, nbits_needed: int
                     ) -> List[BooleanBlock]:
        """LSB-first bits of the shift amount (only log2(total bits) used)."""
        bpb = self._bits_per_block()
        sks = self.key
        bits: List[BooleanBlock] = []
        for k in range(nbits_needed):
            blk, j = divmod(k, bpb)
            if blk >= amount.num_blocks:
                bits.append(self.create_trivial_bool(False))
                continue
            lut = sks.generate_lookup_table(lambda x, jj=j: (x >> jj) & 1)
            bits.append(BooleanBlock(sks.apply_lookup_table_batch(
                _slice(amount.blocks, blk, blk + 1), lut)))
        return bits

    def _barrel(self, a: RadixCiphertext, amount: RadixCiphertext,
                stage) -> RadixCiphertext:
        nbits = a.num_blocks * self._bits_per_block()
        bits = self._amount_bits(amount, (nbits - 1).bit_length())
        cur = a
        for k, bit in enumerate(bits):
            shifted = stage(cur, 1 << k)
            cur = self.if_then_else_parallelized(bit, shifted, cur)
        return cur

    def left_shift_parallelized(self, a: RadixCiphertext,
                                amount: RadixCiphertext) -> RadixCiphertext:
        return self._barrel(a, amount, self.scalar_left_shift_parallelized)

    def right_shift_parallelized(self, a: RadixCiphertext,
                                 amount: RadixCiphertext) -> RadixCiphertext:
        return self._barrel(a, amount, self.scalar_right_shift_parallelized)

    def rotate_left_parallelized(self, a: RadixCiphertext,
                                 amount: RadixCiphertext) -> RadixCiphertext:
        return self._barrel(a, amount, self.scalar_rotate_left_parallelized)

    def rotate_right_parallelized(self, a: RadixCiphertext,
                                  amount: RadixCiphertext) -> RadixCiphertext:
        return self._barrel(a, amount, self.scalar_rotate_right_parallelized)

    # ------------------------------------------------------------------
    # division (ref: radix_parallel/div_mod.rs:12-600 shift-subtract:
    # MSB-first bit recurrence r = 2r + bit; if r >= d then r -= d)
    # ------------------------------------------------------------------

    def div_rem_parallelized(self, a: RadixCiphertext, b: RadixCiphertext
                             ) -> Tuple[RadixCiphertext, RadixCiphertext]:
        sks = self.key
        nb = a.num_blocks
        bpb = self._bits_per_block()
        nbits = nb * bpb
        # numerator bits, MSB first
        bit_luts = [sks.generate_lookup_table(lambda x, jj=j: (x >> jj) & 1)
                    for j in range(bpb)]
        r = self.create_trivial_radix(0, nb)
        q_bits: List[ShortintBatch] = []
        for k in range(nbits - 1, -1, -1):
            blk, j = divmod(k, bpb)
            bit = sks.apply_lookup_table_batch(
                _slice(a.blocks, blk, blk + 1), bit_luts[j])
            r2_blocks = self.scalar_left_shift_parallelized(r, 1).blocks
            # value <= msg-1 (the shifted low bit is zero) but the tracked
            # degree says msg; one message-extract restores the invariant
            first = sks.message_extract_batch(
                sks.unchecked_add_batch(_slice(r2_blocks, 0, 1), bit))
            r2 = RadixCiphertext(_concat([first, _slice(r2_blocks, 1, nb)])
                                 if nb > 1 else first)
            ge = self.ge_parallelized(r2, b)
            diff = self.sub_parallelized(r2, b)
            r = self.if_then_else_parallelized(ge, diff, r2)
            q_bits.append(ge.block)
        # assemble quotient blocks from bits (no carries: values < msg)
        q_blocks: List[ShortintBatch] = []
        for i in range(nb):
            acc = None
            for j in range(bpb):
                blk = q_bits[nbits - 1 - (i * bpb + j)]  # MSB-first
                term = sks.unchecked_scalar_mul_batch(blk, 1 << j)
                acc = term if acc is None else sks.unchecked_add_batch(acc,
                                                                       term)
            q_blocks.append(acc)
        return RadixCiphertext(_concat(q_blocks)), r

    def div_parallelized(self, a, b):
        return self.div_rem_parallelized(a, b)[0]

    def rem_parallelized(self, a, b):
        return self.div_rem_parallelized(a, b)[1]

    # ------------------------------------------------------------------
    # radix casting (ref: integer/server_key/radix/mod.rs
    # extend_radix_with_trivial_zero_blocks_msb / trim_radix_blocks_msb /
    # extend_radix_with_sign_msb; used by high_level_api cast_into)
    # ------------------------------------------------------------------

    def extend_radix_with_trivial_zero_blocks_msb(
            self, a: RadixCiphertext, n: int) -> RadixCiphertext:
        return RadixCiphertext(_concat([a.blocks, self._zeros(n)]))

    def trim_radix_blocks_msb(self, a: RadixCiphertext,
                              n: int) -> RadixCiphertext:
        return RadixCiphertext(_slice(a.blocks, 0, a.num_blocks - n))

    def extend_radix_with_sign_msb(self, a: SignedRadixCiphertext,
                                   n: int) -> SignedRadixCiphertext:
        """Sign-extend: one PBS computes the fill block (msg-1 if negative
        else 0), replicated across the n new MSB blocks."""
        msg = self._msg
        nb = a.num_blocks
        fill_lut = self.key.generate_lookup_table(
            lambda x: msg - 1 if (x % msg) >= msg // 2 else 0)
        fill = self.key.apply_lookup_table_batch(_slice(a.blocks, nb - 1, nb),
                                                 fill_lut)
        fills = _concat([fill] * n) if n else self._zeros(0)
        return SignedRadixCiphertext(_concat([a.blocks, fills]))

    def cast_to_unsigned(self, a: RadixCiphertext,
                         target_blocks: int) -> RadixCiphertext:
        """(ref: radix/mod.rs cast_to_unsigned; carries are cleaned first so
        trimming/extension acts on true block values)"""
        blocks = a.blocks
        if int(blocks.degrees.max(initial=0)) >= self._msg:
            blocks = self.full_propagate(blocks)
        clean = type(a)(blocks)
        nb = clean.num_blocks
        if target_blocks < nb:
            return RadixCiphertext(_slice(clean.blocks, 0, target_blocks))
        if target_blocks == nb:
            return RadixCiphertext(clean.blocks)
        if isinstance(a, SignedRadixCiphertext):
            wide = self.extend_radix_with_sign_msb(clean, target_blocks - nb)
            return RadixCiphertext(wide.blocks)
        return self.extend_radix_with_trivial_zero_blocks_msb(
            RadixCiphertext(clean.blocks), target_blocks - nb)

    def cast_to_signed(self, a: RadixCiphertext,
                       target_blocks: int) -> SignedRadixCiphertext:
        return SignedRadixCiphertext(
            self.cast_to_unsigned(a, target_blocks).blocks)

    # ------------------------------------------------------------------
    # scalar division by a clear constant: Granlund–Montgomery
    # multiply-shift on a widened radix (ref: radix_parallel/
    # scalar_div_mod.rs)
    # ------------------------------------------------------------------

    def scalar_div_parallelized(self, a: RadixCiphertext, d: int
                                ) -> RadixCiphertext:
        if d <= 0:
            raise ValueError("divisor must be positive")
        nb = a.num_blocks
        bpb = self._bits_per_block()
        nbits = nb * bpb
        if d == 1:
            return RadixCiphertext(self.full_propagate(a.blocks.copy()))
        if d & (d - 1) == 0:
            return self.scalar_right_shift_parallelized(
                a, d.bit_length() - 1)
        l = (d - 1).bit_length()  # ceil(log2 d)  # noqa: E741
        m = ((1 << (nbits + l)) + d - 1) // d  # < 2^(l+1) + 2^nbits
        wide_blocks = -(-(2 * nbits + l) // bpb)
        aw = self.extend_radix_with_trivial_zero_blocks_msb(
            a, wide_blocks - nb)
        prod = self.scalar_mul_parallelized(aw, m)
        shifted = self.scalar_right_shift_parallelized(prod, nbits + l)
        return RadixCiphertext(_slice(shifted.blocks, 0, nb))

    def scalar_rem_parallelized(self, a: RadixCiphertext, d: int
                                ) -> RadixCiphertext:
        q = self.scalar_div_parallelized(a, d)
        qd = self.scalar_mul_parallelized(q, d)
        return self.sub_parallelized(a, qd)

    # ------------------------------------------------------------------
    # overflow-reporting ops (ref: radix_parallel/add.rs overflowing_add,
    # sub.rs overflowing_sub)
    # ------------------------------------------------------------------

    def overflowing_add_parallelized(self, a: RadixCiphertext,
                                     b: RadixCiphertext):
        s = self.key.unchecked_add_batch(a.blocks, b.blocks)
        clean, carry_out = self.propagate_single_carry(s)
        return RadixCiphertext(clean), BooleanBlock(carry_out)

    def overflowing_sub_parallelized(self, a: RadixCiphertext,
                                     b: RadixCiphertext):
        return self.sub_parallelized(a, b), self.lt_parallelized(a, b)

    # ------------------------------------------------------------------
    # multi-operand sum (ref: radix_parallel/add.rs:789
    # unchecked_sum_ciphertexts_vec_parallelized carry-save tree)
    # ------------------------------------------------------------------

    def sum_ciphertexts_parallelized(self, cts: List[RadixCiphertext]
                                     ) -> RadixCiphertext:
        if not cts:
            raise ValueError("empty sum")
        if len(cts) == 1:
            return cts[0].copy()
        nb = cts[0].num_blocks
        columns: List[List[ShortintBatch]] = [[] for _ in range(nb)]
        for ct in cts:
            for i in range(nb):
                columns[i].append(_slice(ct.blocks, i, i + 1))
        return RadixCiphertext(self._sum_columns(columns))
