"""Batched radix ops: B radix integers at once, one keyswitch + PBS wave per
PBS round.

Port of `tfhe_tpu/integer/batched.py:35-309`.  A radix op is a host
schedule of waves over a [B, nb, lwe_size] grid of clean block words (int64
torus tensors on the key's device), with linear torus glue (adds, shifts,
bivariate packing) between them; every wave is one call of the shortint
key's `_pbs_device` over all B*nb (or B) rows.  No degree or noise is
tracked: the inputs are clean (degree < message_modulus) and each schedule
is fixed.

Schedules mirrored:
- add/sub/neg: single-carry propagation, by the Hillis-Steele scan or the
  ripple chain (`mode`; ref: integer/server_key/radix_parallel/add.rs:
  518-603 for the scan);
- mul: bivariate block products and the carry-save column reduction
  (ref: radix_parallel/mul.rs:329-464);
- eq/ne: sum-packed block equality (carry-space sums of fresh 0/1 blocks
  in place of the pairwise AND tree);
- lt/le/gt/ge: 3-state sign blocks and the MSB-first resolve tree (ref:
  integer/server_key/comparator.rs:31-60).

The carry schedule is an argument: "scan" or "ripple", anything else
raises.  The reference reads it from TFHE_TPU_CARRY_MODE, falls back to the
scan on an unknown value, and resolves "auto" with a TPU cost model; the
port has no automatic choice until a card measurement can make one.
"""

from __future__ import annotations

import numpy as np
import torch

from .fused import _const, _neg_correct, _shift_blocks_up

CARRY_MODES = ("scan", "ripple")


class BatchedRadixOps:
    """Batched radix arithmetic over block grids [B, nb, lwe_size] of CLEAN
    radix blocks (degree < message_modulus), least significant first: the
    layout RadixCiphertext.blocks.data stacks to.

    mode: the carry propagation's schedule, "scan" (Hillis-Steele over
    3-state blocks: 3 + log2(nb) waves, each B*nb wide; the lower latency)
    or "ripple" (one B-wide carry wave per block, then one B*nb-wide
    message extract: about 2 PBS a block in place of 3 + log2(nb), so fewer
    PBS where throughput binds).  Both hold the same invariant: every
    block that takes a carry-in holds at most 2*msg-2 (a sum of two clean
    blocks); only the carry-free least significant block may reach
    2*msg-1 (a negation's correction)."""

    def __init__(self, sks, mode: str):
        if mode not in CARRY_MODES:
            raise ValueError(f"unknown carry schedule {mode!r}; expected one "
                             f"of {CARRY_MODES}")
        self.sks = sks  # shortint ServerKey
        self.mode = mode
        self.msg = sks.message_modulus
        self.cap = int(sks.max_noise_level)
        self._luts = {}

    # -- wave primitive ---------------------------------------------------

    def _lut(self, key, f):
        if key not in self._luts:
            self._luts[key] = self.sks.generate_lookup_table(f)
        return self._luts[key]

    def _wave(self, data, lut_key, f):
        """One keyswitch + PBS wave over [..., sz] torus rows, on the
        device end to end."""
        lut = self._lut(lut_key, f)
        out = self.sks._pbs_device(data.reshape(-1, data.shape[-1]), lut.acc)
        return out.reshape(data.shape)

    def _biv(self, a, b, lut_key, f):
        """Bivariate wave: LUT(x*msg + y) with x, y clean blocks."""
        msg = self.msg
        return self._wave(a * msg + b, ("biv", lut_key),
                          lambda v: f(v // msg, v % msg))

    # -- carry propagation (ref: radix_parallel/add.rs:518-603) -----------

    def _propagate(self, s):
        """Clean [B, nb, sz] blocks holding sums in the schedule's
        invariant (every block with a carry-in at most 2*msg-2, the least
        significant block at most 2*msg-1), in the key's carry schedule."""
        if self.mode == "ripple":
            return self._propagate_ripple(s)
        msg = self.msg
        nb = s.shape[1]
        state = self._wave(
            s, "state",
            lambda v: 2 if v >= msg else (1 if v == msg - 1 else 0))
        d = 1
        while d < nb:
            packed = state * msg + _shift_blocks_up(state, d)
            state = self._wave(
                packed, "resolve",
                lambda v: min((v % msg) if (v // msg) == 1 else (v // msg),
                              2))
            d *= 2
        carries = self._wave(state, "carry", lambda v: 1 if v == 2 else 0)
        return self._wave(s + _shift_blocks_up(carries, 1), "msgext",
                          lambda v: v % msg)

    def _propagate_ripple(self, s):
        """Serial carry chain: carry_i = LUT(s_i + carry_{i-1}) >= msg.

        A block that takes a carry-in holds at most 2*msg-2, so with the
        0/1 carry the LUT's argument stays below 2*msg <= msg*carry_mod (a
        carry-in on a block at 2*msg-1 would reach 2*msg and be misread);
        only the carry-free least significant block may reach 2*msg-1.
        The noise level is that of 3 fresh blocks, within max_noise_level
        (2_2: 5)."""
        msg = self.msg
        nb = s.shape[1]
        if nb == 1:
            return self._wave(s, "msgext", lambda v: v % msg)
        carry_lut = ("rcarry", lambda v: 1 if v >= msg else 0)
        carry = self._wave(s[:, 0], *carry_lut)
        carries = [carry]
        for i in range(1, nb - 1):
            carry = self._wave(s[:, i] + carry, *carry_lut)
            carries.append(carry)
        shifted = torch.cat([torch.zeros_like(s[:, :1]),
                             torch.stack(carries, dim=1)], dim=1)
        return self._wave(s + shifted, "msgext", lambda v: v % msg)

    # -- public ops --------------------------------------------------------

    def add(self, a, b):
        return self._propagate(a + b)

    def _neg_correct(self, b):
        """Per-block negation's correcting terms for clean blocks (ref:
        integer/server_key/radix/neg.rs; see fused._neg_correct)."""
        sks = self.sks
        return _neg_correct(b, message_modulus=self.msg,
                            carry_modulus=sks.carry_modulus, delta=sks.delta)

    def sub(self, a, b):
        return self._propagate(a + self._neg_correct(b))

    def neg(self, a):
        return self._propagate(self._neg_correct(a))

    def eq(self, a, b):
        """[B, nb, sz] x2 -> [B, sz] 0/1 boolean blocks, sum-packed."""
        beq = self._biv(a, b, "eq", lambda x, y: int(x == y))
        return self._all_ones(beq)

    def ne(self, a, b):
        return self._wave(self.eq(a, b), "not01", lambda v: int(v == 0))

    def _all_ones(self, bits):
        """AND over axis 1 of 0/1 blocks through carry-space sum thresholds
        (fan-in max_noise_level a round)."""
        while bits.shape[1] > 1:
            m = bits.shape[1]
            c = min(self.cap, m)
            pad = (-m) % c
            if pad:
                one = torch.zeros((bits.shape[0], pad, bits.shape[2]),
                                  dtype=bits.dtype, device=bits.device)
                one[..., -1] = self.sks.delta  # trivial encryptions of 1
                bits = torch.cat([bits, one], dim=1)
                m += pad
            s = bits.reshape(bits.shape[0], m // c, c,
                             bits.shape[2]).sum(dim=2)
            bits = self._wave(s, ("and_sum", c), lambda v, c=c: int(v == c))
        return bits[:, 0]

    def _signs(self, a, b):
        """MSB-first reduced 3-state comparison sign [B, sz] (ref:
        comparator.rs:31-60)."""
        msg = self.msg
        signs = self._biv(a, b, "sign",
                          lambda x, y: 0 if x == y else (1 if x < y else 2))
        # resolve tree: the most significant block wins unless equal
        while signs.shape[1] > 1:
            m = signs.shape[1]
            packed = signs[:, 1:m:2] * msg + signs[:, 0:m - 1:2]
            merged = self._wave(
                packed, "sresolve",
                lambda v: min((v % msg) if (v // msg) == 0 else (v // msg),
                              2))
            if m % 2 == 1:
                merged = torch.cat([merged, signs[:, m - 1:m]], dim=1)
            signs = merged
        return signs[:, 0]

    def _cmp(self, a, b, name, f):
        return self._wave(self._signs(a, b), ("cmp", name), f)

    def lt(self, a, b):
        return self._cmp(a, b, "lt", lambda s: int(s == 1))

    def le(self, a, b):
        return self._cmp(a, b, "le", lambda s: int(s != 2))

    def gt(self, a, b):
        return self._cmp(a, b, "gt", lambda s: int(s == 2))

    def ge(self, a, b):
        return self._cmp(a, b, "ge", lambda s: int(s != 1))

    def mul(self, a, b):
        """Carry-save block-product multiplication (ref: radix_parallel/
        mul.rs:329-464 and the add.rs:789 sum trees)."""
        msg = self.msg
        B, nb, sz = a.shape
        dev = a.device
        pairs_lsb = [(i, j) for j in range(nb) for i in range(nb - j)]
        pairs_msb = [(i, j) for j in range(nb) for i in range(nb - j)
                     if i + j + 1 < nb]

        def products(pairs, key, f):
            ai = _const([i for i, _ in pairs], dev)
            bj = _const([j for _, j in pairs], dev)
            return self._biv(a[:, ai], b[:, bj], key, f)

        prod_lsb = products(pairs_lsb, "mlsb", lambda x, y: (x * y) % msg)
        columns = [[] for _ in range(nb)]
        for t, (i, j) in enumerate(pairs_lsb):
            columns[i + j].append(prod_lsb[:, t])
        if pairs_msb:
            prod_msb = products(pairs_msb, "mmsb",
                                lambda x, y: (x * y) // msg)
            for t, (i, j) in enumerate(pairs_msb):
                columns[i + j + 1].append(prod_msb[:, t])

        chunk = max((msg * self.sks.carry_modulus - 1) // (msg - 1), 2)
        while max(len(c) for c in columns) > 2:
            new_columns = [[] for _ in range(nb)]
            to_extract = []
            for p, col in enumerate(columns):
                for lo in range(0, len(col), chunk):
                    part = col[lo:lo + chunk]
                    if len(part) == 1:
                        new_columns[p].append(part[0])
                        continue
                    acc = part[0]
                    for other in part[1:]:
                        acc = acc + other
                    to_extract.append((p, acc))
            if to_extract:
                stacked = torch.stack([t[1] for t in to_extract], dim=1)
                msgs = self._wave(stacked, "msgext", lambda v: v % msg)
                carries = self._wave(stacked, "carryext",
                                     lambda v: v // msg)
                for t, (p, _) in enumerate(to_extract):
                    new_columns[p].append(msgs[:, t])
                    if p + 1 < nb:
                        new_columns[p + 1].append(carries[:, t])
            columns = new_columns

        zero = torch.zeros((B, sz), dtype=a.dtype, device=dev)
        top = torch.stack([c[0] if c else zero for c in columns], dim=1)
        bot = torch.stack([c[1] if len(c) > 1 else zero for c in columns],
                          dim=1)
        return self._propagate(top + bot)


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
