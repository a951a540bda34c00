"""String server key: about 30 std-string operations over encrypted ASCII.

Port of `tfhe_tpu/strings/server_key.py` (ref: tfhe/examples/fhe_strings/
server_key/: comparisons.rs, contains.rs, starts_with.rs, ends_with.rs,
find.rs, change_case.rs, change_padding.rs, add.rs, repeat.rs,
substring.rs, trim.rs, strip.rs, is_empty.rs).  Every per-character loop of
the reference becomes a stacked ShortintBatch, so each round of character
comparisons, selects or folds is ONE shortint batch call (one keyswitch and
one blind rotation on a card); AND/OR folds and prefix scans run in
logarithmic rounds.  Every op makes the reference's PBS batches in the
reference's order, so its outputs equal the reference's word for word.

Block data stays on the key's device: where the reference reads blocks
back to the host for numpy arithmetic (block sums, the barrel shift's
rolls, scatter writes), the port runs torch ops on the device, and its
int64 sums wrap as the reference's uint64 ones.  Where the reference writes
into a block array in place, the port writes only into a tensor the op
made itself (a gather, a concatenation or a clone), never into a view of
an input.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ..integer import IntegerServerKey
from ..integer.ciphertext import BooleanBlock, RadixCiphertext
from ..integer.server_key import _concat as _cat
from ..integer.server_key import _gather as _take
from ..shortint.ciphertext import ShortintBatch
from .ciphertext import FheAsciiChar, FheString, Padding
from .client_key import NUMBER_BLOCKS
from .split import SplitOps

_U64 = np.uint64

Pattern = Union[str, bytes, int, FheAsciiChar, FheString]


def _rows(b: ShortintBatch, idx) -> torch.Tensor:
    """An index tensor for rows `idx` of b's data, on b's device."""
    return torch.from_numpy(np.asarray(idx, dtype=np.int64)).to(
        b.data.device)


class StringServerKey(SplitOps):
    def __init__(self, integer_key: IntegerServerKey):
        self.integer_key = integer_key
        self.sks = integer_key.key
        self.nb = NUMBER_BLOCKS
        self.msg = integer_key.message_modulus
        self._lut_cache: dict = {}

    # ==================================================================
    # stacked-character machinery
    # ==================================================================

    def _stack(self, cts: List[RadixCiphertext]) -> ShortintBatch:
        return _cat([c.blocks for c in cts])

    def _unstack(self, b: ShortintBatch, n: int) -> List[RadixCiphertext]:
        nb = len(b) // n
        return [RadixCiphertext(_take(b, range(i * nb, (i + 1) * nb)))
                for i in range(n)]

    def _trivial_chars(self, values) -> ShortintBatch:
        """Trivial radix blocks of clear chars -> [n*nb]."""
        msg = self.msg
        digits = []
        for v in values:
            digits.extend((int(v) // msg**j) % msg for j in range(self.nb))
        return self.sks.trivial_batch(np.asarray(digits, dtype=_U64),
                                      len(values) * self.nb)

    def _content_stack(self, s: FheString, upto: Optional[int] = None
                       ) -> ShortintBatch:
        n = upto if upto is not None else s.max_len
        parts = [c.ct.blocks for c in s.content[:n]]
        if n > s.max_len:
            parts.append(self._trivial_chars([0] * (n - s.max_len)))
        if not parts:
            return self._trivial_chars([])
        return _cat(parts)

    def _gather_chars(self, s: FheString, indices: List[int]
                      ) -> ShortintBatch:
        """s.content[i] stacked for each i (a trivial zero char where
        i >= max_len)."""
        zero = None
        parts = []
        for i in indices:
            if i < s.max_len:
                parts.append(s.content[i].ct.blocks)
            else:
                if zero is None:
                    zero = self._trivial_chars([0])
                parts.append(zero)
        return _cat(parts) if parts else self._trivial_chars([])

    # -- grouped binary-tree reduction ------------------------------------

    def _tree_reduce(self, b: ShortintBatch, num: int, blut
                     ) -> ShortintBatch:
        """Reduce groups of m contiguous blocks to one block a group.

        A pair (2i, 2i+1) combines with the HIGHER index as the bivariate
        lhs; an odd leftover (most significant) passes through at the end of
        its group."""
        m = len(b) // num
        while m > 1:
            arr = np.arange(num * m).reshape(num, m)
            lo = _take(b, arr[:, 0:m - 1:2].ravel())
            hi = _take(b, arr[:, 1:m:2].ravel())
            merged = self.sks.unchecked_bivariate_batch(hi, lo, blut)
            pairs = m // 2
            if m % 2 == 1:
                leftover = _take(b, arr[:, m - 1])
                # interleave: per group [merged..., leftover]
                out_rows = []
                for g in range(num):
                    out_rows.append(_take(merged,
                                          range(g * pairs, (g + 1) * pairs)))
                    out_rows.append(_take(leftover, [g]))
                b = _cat(out_rows)
            else:
                b = merged
            m = pairs + (m % 2)
        return b

    def _scan(self, b: ShortintBatch, num: int, blut, reverse: bool = False,
              fill: int = 0) -> ShortintBatch:
        """Grouped inclusive Hillis-Steele prefix combine (left to right, or
        right to left when reverse).  `fill` is the identity shifted in at
        the boundary (0 for OR, 1 for AND)."""
        m = len(b) // num
        d = 1
        while d < m:
            # a fresh batch (a concatenation): the fill writes stay in it
            if reverse:
                prev = self.integer_key._shift_blocks_down(b, d, num=num)
            else:
                prev = self.integer_key._shift_blocks_up(b, d, num=num)
            if fill:
                arr = np.arange(num * m).reshape(num, m)
                pad_idx = (arr[:, m - d:].ravel() if reverse
                           else arr[:, :d].ravel())
                fills = self.sks.trivial_batch(
                    np.full(len(pad_idx), fill, dtype=_U64), len(pad_idx))
                prev.data[_rows(prev, pad_idx)] = fills.data
                prev.degrees[pad_idx] = fills.degrees
                prev.noise[pad_idx] = fills.noise
            b = self.sks.unchecked_bivariate_batch(b, prev, blut)
            d *= 2
        return b

    # -- character-level comparisons ----------------------------------

    def _sign_blut(self):
        return self.sks.generate_lookup_table_bivariate(
            lambda x, y: 0 if x == y else (1 if x < y else 2))

    def _resolve_blut(self):
        """combine(high, low) = high unless equal; the inputs are 3-state
        signs (<= 2) and the table is clamped there, so the tracked degree
        stays 2."""
        return self.sks.generate_lookup_table_bivariate(
            lambda high, low: min(low if high == 0 else high, 2))

    def _char_signs(self, a_stack: ShortintBatch, b_stack: ShortintBatch,
                    n: int) -> ShortintBatch:
        """Per-char 3-state sign (0 eq, 1 lt, 2 gt) -> [n]."""
        signs = self.sks.unchecked_bivariate_batch(a_stack, b_stack,
                                                   self._sign_blut())
        return self._tree_reduce(signs, n, self._resolve_blut())

    def _cached_lut(self, key, build):
        if key not in self._lut_cache:
            self._lut_cache[key] = build()
        return self._lut_cache[key]

    def _beq_blut(self):
        return self._cached_lut("beq", lambda: (
            self.sks.generate_lookup_table_bivariate(
                lambda x, y: int(x == y))))

    def _char_eq(self, a_stack, b_stack, n) -> ShortintBatch:
        """Per-char 0/1 equality in TWO PBS rounds: one bivariate block-eq
        batch, then one sum-threshold batch over the nb bits of a char
        (carry-space sums of fresh bools stay within max_noise_level; ref:
        fhe_strings server_key/comparisons.rs eq loops)."""
        sks = self.sks
        beq = sks.unchecked_bivariate_batch(a_stack, b_stack,
                                            self._beq_blut())
        nb = self.nb
        if nb == 1:
            return beq
        if nb > sks.max_noise_level:
            raise ValueError("sum-packed char equality needs nb <= "
                             "max_noise_level")
        arr = np.arange(n * nb).reshape(n, nb)
        s = _take(beq, arr[:, 0])
        for k in range(1, nb):
            s = sks.unchecked_add_batch(s, _take(beq, arr[:, k]))
        lut = self._cached_lut(("sum_eq", nb), lambda: (
            sks.generate_lookup_table(lambda x: int(x == nb))))
        return sks.apply_lookup_table_batch(s, lut)

    def _bool_reduce(self, b: ShortintBatch, num: int, op: str
                     ) -> ShortintBatch:
        """Grouped AND/OR of 0/1 blocks through carry-space sum thresholds:
        each round collapses min(max_noise_level, m) bools a chunk with ONE
        PBS (a sum of k unit-noise bools has noise level and degree k, both
        in contract), a fan-in of 5 in place of the bivariate tree's 2
        (ref: pattern.rs:106-115 folds pairwise)."""
        sks = self.sks
        m = len(b) // num
        cap = int(sks.max_noise_level)
        fillv = 1 if op == "and" else 0
        while m > 1:
            c = min(cap, m)
            pad = (-m) % c
            if pad:
                fills = sks.trivial_batch(
                    np.full(num * pad, fillv, dtype=_U64), num * pad)
                rows = []
                for g in range(num):
                    rows.append(_take(b, range(g * m, (g + 1) * m)))
                    rows.append(_take(fills, range(g * pad, (g + 1) * pad)))
                b = _cat(rows)
                m += pad
            arr = np.arange(num * m).reshape(num * (m // c), c)
            s = _take(b, arr[:, 0])
            for k in range(1, c):
                s = sks.unchecked_add_batch(s, _take(b, arr[:, k]))
            if op == "and":
                lut = self._cached_lut(("and_sum", c), lambda c=c: (
                    sks.generate_lookup_table(lambda x: int(x == c))))
            else:
                lut = self._cached_lut(("or_sum", c), lambda c=c: (
                    sks.generate_lookup_table(lambda x: int(x != 0))))
            b = sks.apply_lookup_table_batch(s, lut)
            m //= c
        return b

    def _prefix_or(self, b: ShortintBatch, reverse: bool = False
                   ) -> ShortintBatch:
        """Inclusive prefix-OR of a 0/1 block vector in about 3 PBS rounds:
        linear prefix sums within chunks of max_noise_level, one threshold
        LUT for the in-chunk prefix-ORs, the chunks' exclusive prefixes
        recursively, one bivariate OR to merge (the find/rfind hot path)."""
        sks = self.sks
        n = len(b)
        if n == 1:
            return _take(b, [0])
        if reverse:
            rev = np.arange(n - 1, -1, -1)
            return _take(self._prefix_or(_take(b, rev)), rev)
        cap = int(sks.max_noise_level)
        or_lut = self._cached_lut(("or_sum", cap), lambda: (
            sks.generate_lookup_table(lambda x: int(x != 0))))
        # in-chunk inclusive prefix sums (linear), in a gathered copy
        s = _take(b, np.arange(n))
        for k in range(1, cap):
            idx = np.asarray([i for i in range(n) if i % cap >= k])
            if idx.size == 0:
                break
            # s[i] += b[i - k]: after every k, s[i] sums b over its chunk
            # prefix (i % cap + 1 terms, noise <= cap)
            add = sks.unchecked_add_batch(_take(s, idx), _take(b, idx - k))
            s.data[_rows(s, idx)] = add.data
            s.degrees[idx] = add.degrees
            s.noise[idx] = add.noise
        pc = sks.apply_lookup_table_batch(s, or_lut)       # [n]
        nchunk = -(-n // cap)
        if nchunk == 1:
            return pc
        ends = np.minimum(np.arange(1, nchunk + 1) * cap - 1, n - 1)
        tp = self._prefix_or(_take(pc, ends))              # chunk ORs
        # exclusive shift: chunk j sees the OR of the chunks before it
        prev = _take(tp, np.maximum(np.arange(nchunk) - 1, 0))
        prev.data[0] = sks.trivial_batch(np.zeros(1, dtype=_U64), 1).data[0]
        prev.degrees[0] = 0
        prev.noise[0] = 0
        prev_rep = _take(prev, np.repeat(np.arange(nchunk), cap)[:n])
        return sks.unchecked_bivariate_batch(pc, prev_rep, self._or_blut())

    def _and_blut(self):
        # an explicit 0/1 output keeps the tracked degree of boolean blocks
        # at 1 (a plain `a & b` table has full-domain maximum 3)
        return self.sks.generate_lookup_table_bivariate(
            lambda a, b: int(bool(a) and bool(b)))

    def _or_blut(self):
        return self.sks.generate_lookup_table_bivariate(
            lambda a, b: int(bool(a) or bool(b)))

    def _bool_fold(self, bools: ShortintBatch, op: str) -> BooleanBlock:
        return BooleanBlock(self._bool_reduce(bools, 1, op))

    def _bools_count(self, bools: ShortintBatch) -> RadixCiphertext:
        """The sum of 0/1 blocks as a radix integer."""
        columns = [[_take(bools, [i]) for i in range(len(bools))]]
        columns += [[] for _ in range(self.nb - 1)]
        return RadixCiphertext(self.integer_key._sum_columns(columns))

    def _weighted_index_sum(self, firsts: ShortintBatch) -> RadixCiphertext:
        """sum_i i * firsts[i] as a radix integer (no PBS for the
        weighting)."""
        msg = self.msg
        columns: List[List[ShortintBatch]] = [[] for _ in range(self.nb)]
        for i in range(len(firsts)):
            for j in range(self.nb):
                dgt = (i // msg**j) % msg
                if dgt:
                    columns[j].append(self.sks.unchecked_scalar_mul_batch(
                        _take(firsts, [i]), dgt))
        if not any(columns):
            return self.integer_key.create_trivial_radix(0, self.nb)
        return RadixCiphertext(self.integer_key._sum_columns(columns))

    # -- batched per-char select / arithmetic -------------------------

    def _repeat_bool_per_block(self, cond: ShortintBatch) -> ShortintBatch:
        """[n] 0/1 blocks -> [n*nb], each repeated for its char's blocks."""
        return _take(cond, np.repeat(np.arange(len(cond)), self.nb))

    def _char_cmux(self, cond: ShortintBatch, a_stack: ShortintBatch,
                   b_stack: ShortintBatch) -> ShortintBatch:
        """Per char: cond ? a : b (cond [n] 0/1; stacks [n*nb])."""
        sks = self.sks
        c = self._repeat_bool_per_block(cond)
        then_lut = sks.generate_lookup_table_bivariate(
            lambda cc, x: x if cc else 0)
        else_lut = sks.generate_lookup_table_bivariate(
            lambda cc, x: 0 if cc else x)
        ta = sks.unchecked_bivariate_batch(c, a_stack, then_lut)
        tb = sks.unchecked_bivariate_batch(c, b_stack, else_lut)
        return sks.message_extract_batch(sks.unchecked_add_batch(ta, tb))

    def _char_zero_if(self, cond: ShortintBatch, stack: ShortintBatch
                      ) -> ShortintBatch:
        """Per char: cond ? 0 : char."""
        sks = self.sks
        c = self._repeat_bool_per_block(cond)
        lut = sks.generate_lookup_table_bivariate(
            lambda cc, x: 0 if cc else x)
        return sks.unchecked_bivariate_batch(c, stack, lut)

    def _sub_stacks(self, a_stack: ShortintBatch, b_stack: ShortintBatch,
                    num: int) -> ShortintBatch:
        """Per-char radix subtraction over stacked chars."""
        nbk = self.integer_key._neg_blocks(b_stack, num=num)
        s = self.sks.unchecked_add_batch(a_stack, nbk)
        clean, _ = self.integer_key.propagate_single_carry(s, num=num)
        return clean

    def _masked_sum(self, masked: ShortintBatch, groups: int,
                    width: int) -> ShortintBatch:
        """Block-wise sum over `groups` of `width`-block stacks laid out
        group-major: the torus words add on the device, wrapping as the
        reference's uint64 sums, into [width] blocks of degree msg-1."""
        data = masked.data.reshape(groups, width, -1).sum(dim=0)
        return ShortintBatch(
            data=data, degrees=np.full(width, self.msg - 1, dtype=np.int64),
            message_modulus=self.msg, carry_modulus=masked.carry_modulus)

    # ==================================================================
    # pattern normalization
    # ==================================================================

    def _pattern_stack(self, pattern: Pattern
                       ) -> Tuple[ShortintBatch, int, bool]:
        """-> (stack [plen*nb], plen, is_encrypted_with_padding)."""
        if isinstance(pattern, FheAsciiChar):
            return pattern.ct.blocks, 1, False
        if isinstance(pattern, int):
            return self._trivial_chars([pattern]), 1, False
        if isinstance(pattern, (str, bytes)):
            data = (pattern.encode("ascii") if isinstance(pattern, str)
                    else pattern)
            return self._trivial_chars(list(data)), len(data), False
        if isinstance(pattern, FheString):
            p = self._with_final_padding(pattern)
            return (self._content_stack(p), p.max_len,
                    p.padding != Padding.NONE)
        raise TypeError(f"unsupported pattern type {type(pattern)}")

    def _with_final_padding(self, s: FheString) -> FheString:
        """s with any padding zeros at the end (ref: change_padding.rs
        push_padding_to_end)."""
        if s.padding in (Padding.NONE, Padding.FINAL):
            return s
        return self.push_padding_to_end(s)

    # ==================================================================
    # operations
    # ==================================================================

    # -- length (ref: accessors.rs, is_empty.rs, length_arithmetic.rs) --

    def len_(self, s: FheString):
        return s.length

    def is_empty(self, s: FheString) -> BooleanBlock:
        if isinstance(s.length, int):
            return self.integer_key.create_trivial_bool(s.length == 0)
        return self.integer_key.scalar_eq_parallelized(s.length, 0)

    def _length_radix(self, s: FheString) -> RadixCiphertext:
        if isinstance(s.length, int):
            return self.integer_key.create_trivial_radix(s.length, self.nb)
        return s.length

    # -- comparisons (ref: comparisons.rs) ----------------------------

    def eq(self, s: FheString, pattern: Pattern) -> BooleanBlock:
        pstack, plen, _ = self._pattern_stack(pattern)
        if isinstance(pattern, (str, bytes)) and isinstance(s.length, int) \
                and s.padding == Padding.NONE and plen != s.length:
            return self.integer_key.create_trivial_bool(False)
        s = self._with_final_padding(s)
        n = max(s.max_len, plen)
        if n == 0:  # both empty
            return self.integer_key.create_trivial_bool(True)
        a = self._content_stack(s, upto=n)
        if plen < n:
            pstack = _cat([pstack, self._trivial_chars([0] * (n - plen))])
        eqs = self._char_eq(a, pstack, n)
        return self._bool_fold(eqs, "and")

    def ne(self, s: FheString, pattern: Pattern) -> BooleanBlock:
        return self.integer_key.boolean_bitnot(self.eq(s, pattern))

    def eq_ignore_case(self, s: FheString, pattern: Pattern) -> BooleanBlock:
        s_low = self.to_lowercase(s)
        if isinstance(pattern, (str, bytes)):
            return self.eq(s_low, pattern.lower())
        if isinstance(pattern, FheString):
            return self.eq(s_low, self.to_lowercase(pattern))
        raise TypeError("eq_ignore_case expects a string pattern")

    def _lex_sign(self, s: FheString, pattern: Pattern) -> ShortintBatch:
        """3-state lexicographic sign of (s vs pattern): 0 eq, 1 lt,
        2 gt."""
        pstack, plen, _ = self._pattern_stack(pattern)
        s = self._with_final_padding(s)
        n = max(s.max_len, plen)
        if n == 0:  # both empty: equal
            return self.sks.trivial_batch(np.zeros(1, dtype=_U64), 1)
        a = self._content_stack(s, upto=n)
        if plen < n:
            pstack = _cat([pstack, self._trivial_chars([0] * (n - plen))])
        # [n], the leftmost char the most significant
        signs = self._char_signs(a, pstack, n)
        rev = _take(signs, np.arange(n - 1, -1, -1))
        return self._tree_reduce(rev, 1, self._resolve_blut())

    def _lex_bool(self, s, pattern, f) -> BooleanBlock:
        sign = self._lex_sign(s, pattern)
        lut = self.sks.generate_lookup_table(f)
        return BooleanBlock(self.sks.apply_lookup_table_batch(sign, lut))

    def le(self, s: FheString, pattern: Pattern) -> BooleanBlock:
        return self._lex_bool(s, pattern, lambda x: int(x != 2))

    def ge(self, s: FheString, pattern: Pattern) -> BooleanBlock:
        return self._lex_bool(s, pattern, lambda x: int(x != 1))

    def lt(self, s: FheString, pattern: Pattern) -> BooleanBlock:
        return self._lex_bool(s, pattern, lambda x: int(x == 1))

    def gt(self, s: FheString, pattern: Pattern) -> BooleanBlock:
        return self._lex_bool(s, pattern, lambda x: int(x == 2))

    # -- pattern matching core (ref: pattern.rs:106-115 is_contained_in
    #    OR-fold over offsets; contains.rs:18-41) ----------------------

    def _prefix_matches(self, s: FheString, pattern: Pattern,
                        offsets: List[int]) -> ShortintBatch:
        """match[i] = 1 iff pattern is a prefix of s[i..]: [len(offsets)]."""
        pstack, plen, p_padded = self._pattern_stack(pattern)
        if plen == 0:
            return self.sks.trivial_batch(
                np.ones(len(offsets), dtype=_U64), len(offsets))
        s = self._with_final_padding(s)
        # every (offset, j) character pair at once
        idx = [i + j for i in offsets for j in range(plen)]
        schars = self._gather_chars(s, idx)
        prep = _take(pstack, np.tile(np.arange(plen * self.nb), len(offsets)))
        eqs = self._char_eq(schars, prep, len(offsets) * plen)
        if p_padded:
            # the pattern's padding zeros match anything: is_pad | eq
            zeros = self._trivial_chars([0] * plen)
            is_pad = self._char_eq(pstack, zeros, plen)
            is_pad_rep = _take(is_pad, np.tile(np.arange(plen), len(offsets)))
            eqs = self.sks.unchecked_bivariate_batch(
                is_pad_rep, eqs, self._or_blut())
        return self._bool_reduce(eqs, len(offsets), "and")

    def contains(self, s: FheString, pattern: Pattern) -> BooleanBlock:
        """(ref: contains.rs:18-41)"""
        offsets = list(range(s.max_len))
        if not offsets:
            # an empty haystack contains only the empty pattern
            _, plen, p_padded = self._pattern_stack(pattern)
            if plen == 0:
                return self.integer_key.create_trivial_bool(True)
            if not p_padded:
                return self.integer_key.create_trivial_bool(False)
            return self.is_empty_pattern(pattern)
        matches = self._prefix_matches(s, pattern, offsets)
        return self._bool_fold(matches, "or")

    def is_empty_pattern(self, pattern: Pattern) -> BooleanBlock:
        if isinstance(pattern, FheString):
            return self.is_empty(pattern)
        _, plen, _ = self._pattern_stack(pattern)
        return self.integer_key.create_trivial_bool(plen == 0)

    def starts_with(self, s: FheString, pattern: Pattern) -> BooleanBlock:
        """(ref: starts_with.rs)"""
        return BooleanBlock(self._prefix_matches(s, pattern, [0]))

    def ends_with(self, s: FheString, pattern: Pattern) -> BooleanBlock:
        """(ref: ends_with.rs): the match at offset len(s) - len(p)."""
        _, plen, p_padded = self._pattern_stack(pattern)
        if isinstance(s.length, int) and not p_padded:
            if plen > s.length:
                return self.integer_key.create_trivial_bool(False)
            return BooleanBlock(
                self._prefix_matches(s, pattern, [s.length - plen]))
        # encrypted length: OR_i (prefix_match[i] AND i == len(s) - len(p))
        offsets = list(range(s.max_len + 1))
        matches = self._prefix_matches(s, pattern, offsets)
        len_s = self._length_radix(s)
        if isinstance(pattern, FheString) and pattern.is_encrypted_length():
            d = self.integer_key.sub_parallelized(len_s, pattern.length)
        else:
            d = self.integer_key.scalar_sub_parallelized(len_s, plen)
        # indicator[i] = (d == i), every offset at once
        n = len(offsets)
        d_rep = _take(d.blocks, np.tile(np.arange(self.nb), n))
        ind = self._char_eq(d_rep, self._trivial_chars(offsets), n)
        both = self.sks.unchecked_bivariate_batch(matches, ind,
                                                  self._and_blut())
        return self._bool_fold(both, "or")

    # -- find / rfind (ref: find.rs) ----------------------------------

    def _first_matches(self, matches: ShortintBatch, reverse: bool = False
                       ) -> ShortintBatch:
        """The first (or last) set bit of a 0/1 vector, isolated."""
        return self._first_matches_and_found(matches, reverse)[0]

    def _first_matches_and_found(self, matches: ShortintBatch,
                                 reverse: bool = False):
        """(first-set-bit indicators, OR of all bits): the found flag is
        the prefix-OR's last element, shared."""
        seen = self._prefix_or(matches, reverse=reverse)
        found = BooleanBlock(_take(seen, [0 if reverse
                                          else len(matches) - 1]))
        # inclusive scan, shifted to exclusive
        if reverse:
            before = self.integer_key._shift_blocks_down(seen, 1)
        else:
            before = self.integer_key._shift_blocks_up(seen, 1)
        not_seen_blut = self.sks.generate_lookup_table_bivariate(
            lambda m, sb: int(bool(m) and not sb))
        firsts = self.sks.unchecked_bivariate_batch(matches, before,
                                                    not_seen_blut)
        return firsts, found

    def find(self, s: FheString, pattern: Pattern
             ) -> Tuple[BooleanBlock, RadixCiphertext]:
        """-> (found, index of the first match) (ref: find.rs)."""
        offsets = list(range(max(s.max_len, 1)))
        matches = self._prefix_matches(s, pattern, offsets)
        firsts, found = self._first_matches_and_found(matches)
        return found, self._weighted_index_sum(firsts)

    def rfind(self, s: FheString, pattern: Pattern
              ) -> Tuple[BooleanBlock, RadixCiphertext]:
        offsets = list(range(max(s.max_len, 1)))
        matches = self._prefix_matches(s, pattern, offsets)
        lasts, found = self._first_matches_and_found(matches, reverse=True)
        return found, self._weighted_index_sum(lasts)

    # -- case mapping (ref: change_case.rs:18-82, branchless +-32) ----

    def _case_shift(self, s: FheString, lo: int, hi: int,
                    up: bool) -> FheString:
        n = s.max_len
        if n == 0:
            return s.copy()
        stack = self._content_stack(s)
        in_range = self._char_range_mask(stack, n, lo, hi)
        # delta = 32 * mask as a radix char: per-block scalar products by
        # the base-msg digits of 32 (no PBS)
        msg = self.msg
        digits32 = [(32 // msg**j) % msg for j in range(self.nb)]
        mask_rep = self._repeat_bool_per_block(in_range)  # [n*nb]
        delta_stack = self.sks.unchecked_scalar_mul_batch(
            mask_rep, np.tile(np.asarray(digits32, dtype=np.int64), n))
        if up:
            out = self._sub_stacks(stack, delta_stack, n)
        else:
            ssum = self.sks.unchecked_add_batch(stack, delta_stack)
            out, _ = self.integer_key.propagate_single_carry(ssum, num=n)
        return FheString(
            content=[FheAsciiChar(c) for c in self._unstack(out, n)],
            padding=s.padding,
            length=s.length if isinstance(s.length, int)
            else s.length.copy())

    def _char_range_mask(self, stack: ShortintBatch, n: int, lo: int,
                         hi: int) -> ShortintBatch:
        """[n] booleans: lo <= char <= hi (batched sign comparisons)."""
        sign_lo = self._char_signs(stack, self._trivial_chars([lo] * n), n)
        sign_hi = self._char_signs(stack, self._trivial_chars([hi] * n), n)
        ge_lut = self.sks.generate_lookup_table(lambda x: int(x != 1))
        le_lut = self.sks.generate_lookup_table(lambda x: int(x != 2))
        ge = self.sks.apply_lookup_table_batch(sign_lo, ge_lut)
        le = self.sks.apply_lookup_table_batch(sign_hi, le_lut)
        return self.sks.unchecked_bivariate_batch(ge, le, self._and_blut())

    def to_uppercase(self, s: FheString) -> FheString:
        return self._case_shift(s, ord("a"), ord("z"), up=True)

    def to_lowercase(self, s: FheString) -> FheString:
        return self._case_shift(s, ord("A"), ord("Z"), up=False)

    # -- concat / repeat (ref: add.rs, repeat.rs) ---------------------

    def concat(self, s1: FheString, s2: FheString) -> FheString:
        content = ([FheAsciiChar(c.ct.copy()) for c in s1.content]
                   + [FheAsciiChar(c.ct.copy()) for c in s2.content])
        if isinstance(s1.length, int) and isinstance(s2.length, int):
            length: object = s1.length + s2.length
        else:
            length = self.integer_key.add_parallelized(
                self._length_radix(s1), self._length_radix(s2))
        if s1.padding == Padding.NONE:
            padding = s2.padding
        elif s1.padding == Padding.FINAL and s2.max_len == 0:
            padding = Padding.FINAL
        else:
            padding = Padding.ANYWHERE
        return FheString(content=content, padding=padding, length=length)

    add = concat

    def repeat(self, s: FheString, n: int) -> FheString:
        """A clear repetition count (ref: repeat.rs)."""
        if n == 0:
            return FheString(content=[], padding=Padding.NONE, length=0)
        out = s.copy()
        for _ in range(n - 1):
            out = self.concat(out, s)
        return out

    # -- substring (clear range; ref: substring.rs) -------------------

    def substring(self, s: FheString, start: int, end: int) -> FheString:
        s = self._with_final_padding(s)
        end = min(end, s.max_len)
        start = min(start, end)
        content = [FheAsciiChar(c.ct.copy()) for c in s.content[start:end]]
        width = end - start
        if isinstance(s.length, int):
            length: object = max(min(s.length, end) - start, 0)
            padding = s.padding if length == width else Padding.FINAL
        else:
            ik = self.integer_key
            ge = ik.scalar_cmp_parallelized(s.length, start, "ge")
            diff = ik.scalar_sub_parallelized(s.length, start)
            zero = ik.create_trivial_radix(0, self.nb)
            rem = ik.if_then_else_parallelized(ge, diff, zero)
            width_ct = ik.create_trivial_radix(width, self.nb)
            over = ik.scalar_cmp_parallelized(rem, width, "gt")
            length = ik.if_then_else_parallelized(over, width_ct, rem)
            padding = Padding.FINAL
        return FheString(content=content, padding=padding, length=length)

    # -- accessors (ref: accessors.rs:9-113, substring.rs:59-152) -----

    def nth_clear(self, s: FheString, n: int) -> FheAsciiChar:
        """The n-th character (the zero char when out of range; ref:
        accessors.rs nth_clear)."""
        s = self._with_final_padding(s)
        if n >= s.max_len:
            return FheAsciiChar(RadixCiphertext(self._trivial_chars([0])))
        return FheAsciiChar(RadixCiphertext(
            _take(s.content[n].ct.blocks, list(range(self.nb)))))

    def nth_encrypted(self, s: FheString, n: RadixCiphertext
                      ) -> FheAsciiChar:
        """The character at an encrypted index: one batched index equality
        over every position and a weighted select (ref: accessors.rs
        nth_encrypted; the reference's per-position loop becomes two PBS
        batches)."""
        s = self._with_final_padding(s)
        ln = s.max_len
        stack = self._content_stack(s)
        idx_stack = self._trivial_chars(list(range(ln)))
        n_rep = _take(n.blocks, np.tile(np.arange(self.nb), ln))
        eqs = self._char_eq(idx_stack, n_rep, ln)  # [ln] bools
        c = self._repeat_bool_per_block(eqs)
        pick_lut = self.sks.generate_lookup_table_bivariate(
            lambda cc, x: x if cc else 0)
        masked = self.sks.unchecked_bivariate_batch(c, stack, pick_lut)
        # exactly one position matches: a plain block-wise sum, then clean
        summed = self._masked_sum(masked, ln, self.nb)
        summed.degrees[:] = min(int(masked.degrees.max(initial=0)),
                                self.msg - 1)
        return FheAsciiChar(RadixCiphertext(
            self.sks.message_extract_batch(summed)))

    def _shift_chars_left_encrypted(self, stack: ShortintBatch, ln: int,
                                    amount: RadixCiphertext
                                    ) -> ShortintBatch:
        """Barrel shift of the char stack by an encrypted amount: one
        msg-way select per radix digit of the amount (batched bivariate
        PBS), zeros filled in past the end.  The rolls and the sum run on
        the device."""
        sks = self.sks
        msg = self.msg
        cur = stack
        digit = 0
        while msg ** digit < ln and digit < amount.num_blocks:
            weight = msg ** digit
            blk = _take(amount.blocks, [digit])
            cond = _take(blk, [0] * (ln * self.nb))
            parts = []
            for d in range(msg):
                shift = d * weight
                data = cur.data.reshape(ln, self.nb, -1)
                if shift == 0:
                    rolled = data
                else:
                    zero = self._trivial_chars([0] * min(shift, ln)).data \
                        .reshape(-1, self.nb, data.shape[-1])
                    rolled = (torch.cat([data[shift:], zero]) if shift < ln
                              else zero[:1].expand(data.shape))
                rolled_b = ShortintBatch(
                    data=rolled.reshape(ln * self.nb, -1),
                    degrees=np.full(ln * self.nb, msg - 1, dtype=np.int64),
                    message_modulus=msg, carry_modulus=cur.carry_modulus)
                eq_lut = sks.generate_lookup_table_bivariate(
                    lambda b_, x, d_=d: x if (b_ % msg) == d_ else 0)
                parts.append(sks.unchecked_bivariate_batch(cond, rolled_b,
                                                           eq_lut))
            summed = self._masked_sum(_cat(parts), msg, ln * self.nb)
            cur = sks.message_extract_batch(summed)
            digit += 1
        return cur

    def substring_encrypted(self, s: FheString, start: RadixCiphertext,
                            end: RadixCiphertext) -> FheString:
        """s[start..end] with encrypted bounds (ref: substring.rs
        substring_encrypted:59-116)."""
        ik = self.integer_key
        s = self._with_final_padding(s)
        ln = s.max_len
        stack = self._content_stack(s)
        shifted = self._shift_chars_left_encrypted(stack, ln, start)

        # keep position i iff i < end - start (saturating)
        ge = ik.ge_parallelized(end, start)
        diff = ik.sub_parallelized(end, start)
        zero = ik.create_trivial_radix(0, self.nb)
        keep_len = ik.if_then_else_parallelized(ge, diff, zero)
        idx_stack = self._trivial_chars(list(range(ln)))
        keep_rep = _take(keep_len.blocks, np.tile(np.arange(self.nb), ln))
        signs = self._char_signs(idx_stack, keep_rep, ln)  # 1: i < keep
        drop_lut = self.sks.generate_lookup_table(lambda x: int(x != 1))
        drop = self.sks.apply_lookup_table_batch(signs, drop_lut)
        masked = self._char_zero_if(drop, shifted)

        # length = clamp(min(end, len) - start, 0)
        len_radix = self._length_radix(s)
        over = ik.gt_parallelized(end, len_radix)
        e = ik.if_then_else_parallelized(over, len_radix, end)
        ge2 = ik.ge_parallelized(e, start)
        d2 = ik.sub_parallelized(e, start)
        length = ik.if_then_else_parallelized(ge2, d2, zero)
        return FheString(
            content=[FheAsciiChar(c) for c in self._unstack(masked, ln)],
            padding=Padding.FINAL, length=length)

    # -- trim family (ref: trim.rs) -----------------------------------

    _WHITESPACE = (9, 10, 11, 12, 13, 32)

    def _is_ws_or_zero(self, stack: ShortintBatch, n: int) -> ShortintBatch:
        """[n] booleans: the char is ASCII whitespace or the padding zero.

        A cascade of bivariate LUTs over the radix digits: the state after
        digit j is the class of whitespace codes whose low digits match so
        far, a small id in one block's message space."""
        ws = set(self._WHITESPACE) | {0}
        msg = self.msg
        nb = self.nb
        arr = np.arange(n * nb).reshape(n, nb)
        # the digit tuples of each code (all < 64: the top digit is 0)
        tuples = {tuple((c // msg**j) % msg for j in range(nb)) for c in ws}
        if not all(t[3:] == (0,) * (nb - 3) for t in tuples):
            raise ValueError("whitespace codes need at most 3 digits")
        # the class of (b0, b1): the block-2 digits that keep the char a
        # whitespace candidate; few classes arise, each one block's value
        prefix_to_d2: dict = {}
        for t in tuples:
            prefix_to_d2.setdefault(t[:2], set()).add(t[2])
        classes = sorted({frozenset(v) for v in prefix_to_d2.values()},
                         key=sorted)
        class_ids = {c: i + 1 for i, c in enumerate(classes)}
        if len(class_ids) + 1 > msg:
            raise ValueError("too many whitespace digit classes")

        def pair_f(x1, x0):
            d2s = prefix_to_d2.get((x0, x1))
            return class_ids[frozenset(d2s)] if d2s else 0

        state = self.sks.unchecked_bivariate_batch(
            _take(stack, arr[:, 1]), _take(stack, arr[:, 0]),
            self.sks.generate_lookup_table_bivariate(pair_f))
        id_to_class = {v: k for k, v in class_ids.items()}

        def f2(cls, d):
            return int(cls != 0 and d in id_to_class.get(cls, ()))

        state = self.sks.unchecked_bivariate_batch(
            state, _take(stack, arr[:, 2]),
            self.sks.generate_lookup_table_bivariate(f2))
        for j in range(3, nb):
            state = self.sks.unchecked_bivariate_batch(
                state, _take(stack, arr[:, j]),
                self.sks.generate_lookup_table_bivariate(
                    lambda st, d: int(bool(st) and d == 0)))
        return state

    def trim_end(self, s: FheString) -> FheString:
        """Trailing whitespace stripped (ref: trim.rs)."""
        s = self._with_final_padding(s)
        n = s.max_len
        if n == 0:
            return s.copy()
        stack = self._content_stack(s)
        wsz = self._is_ws_or_zero(stack, n)
        trailing = self._scan(wsz, 1, self._and_blut(), reverse=True, fill=1)
        new_stack = self._char_zero_if(trailing, stack)
        keep_lut = self.sks.generate_lookup_table(lambda x: 1 - (x % 2))
        kept = self.sks.apply_lookup_table_batch(trailing, keep_lut)
        return FheString(
            content=[FheAsciiChar(c) for c in self._unstack(new_stack, n)],
            padding=Padding.FINAL, length=self._bools_count(kept))

    def trim_start(self, s: FheString) -> FheString:
        """Leading whitespace stripped; the zeros stay in front (INITIAL
        padding)."""
        s = self._with_final_padding(s)
        n = s.max_len
        if n == 0:
            return s.copy()
        stack = self._content_stack(s)
        is_ws = self._is_ws_or_zero(stack, n)
        leading = self._scan(is_ws, 1, self._and_blut(), reverse=False,
                             fill=1)
        new_stack = self._char_zero_if(leading, stack)
        keep_lut = self.sks.generate_lookup_table(lambda x: 1 - (x % 2))
        kept = self.sks.apply_lookup_table_batch(leading, keep_lut)
        length = self._bools_count(kept)
        # `kept` = n - #leading counts the trailing padding zeros too (the
        # leading scan stops at the first real char): the true length is
        # len(s) - #leading = kept - (n - len(s))
        if not (isinstance(s.length, int) and s.length == n):
            pad_count = self.integer_key.sub_parallelized(
                self.integer_key.create_trivial_radix(n, self.nb),
                self._length_radix(s))
            length = self.integer_key.sub_parallelized(length, pad_count)
        return FheString(
            content=[FheAsciiChar(c) for c in self._unstack(new_stack, n)],
            padding=(Padding.INITIAL if s.padding == Padding.NONE
                     else Padding.INITIAL_AND_FINAL),
            length=length)

    def trim(self, s: FheString) -> FheString:
        return self.trim_start(self.trim_end(s))

    # -- strip prefix/suffix (ref: strip.rs) --------------------------

    def strip_prefix(self, s: FheString, pattern: Pattern
                     ) -> Tuple[BooleanBlock, FheString]:
        """-> (stripped?, result); the result keeps zeros in place of the
        prefix (INITIAL padding)."""
        pstack, plen, p_padded = self._pattern_stack(pattern)
        matched = self.starts_with(s, pattern)
        s = self._with_final_padding(s)
        n = s.max_len
        if plen == 0 or n == 0:
            return matched, s.copy()
        k = min(plen, n)
        stack = self._content_stack(s)
        # zero position j < k when matched AND pattern char j is not padding
        m_rep = _take(matched.block, np.zeros(k, dtype=np.int64))
        if p_padded:
            zeros = self._trivial_chars([0] * plen)
            is_pad = self._char_eq(pstack, zeros, plen)
            is_real = self.sks.apply_lookup_table_batch(
                _take(is_pad, range(k)),
                self.sks.generate_lookup_table(lambda x: 1 - (x % 2)))
            cond = self.sks.unchecked_bivariate_batch(m_rep, is_real,
                                                      self._and_blut())
        else:
            cond = m_rep
        new_head = self._char_zero_if(cond, _take(stack, range(k * self.nb)))
        tail = _take(stack, range(k * self.nb, n * self.nb))
        new_stack = _cat([new_head, tail]) if n > k else new_head
        # length: matched ? len - len(p) : len
        ik = self.integer_key
        len_s = self._length_radix(s)
        if isinstance(pattern, FheString) and pattern.is_encrypted_length():
            stripped_len = ik.sub_parallelized(len_s, pattern.length)
        else:
            stripped_len = ik.scalar_sub_parallelized(len_s, plen)
        new_len = ik.if_then_else_parallelized(matched, stripped_len, len_s)
        return matched, FheString(
            content=[FheAsciiChar(c) for c in self._unstack(new_stack, n)],
            padding=Padding.INITIAL_AND_FINAL, length=new_len)

    def strip_suffix(self, s: FheString, pattern: Pattern
                     ) -> Tuple[BooleanBlock, FheString]:
        _, plen, _ = self._pattern_stack(pattern)
        matched = self.ends_with(s, pattern)
        s = self._with_final_padding(s)
        n = s.max_len
        if plen == 0 or n == 0:
            return matched, s.copy()
        # zero position i when matched AND i >= len(s) - len(p)
        ik = self.integer_key
        len_s = self._length_radix(s)
        if isinstance(pattern, FheString) and pattern.is_encrypted_length():
            cutoff = ik.sub_parallelized(len_s, pattern.length)
        else:
            cutoff = ik.scalar_sub_parallelized(len_s, plen)
        # per position: i >= cutoff (batched signs against trivial i)
        d_rep = _take(cutoff.blocks, np.tile(np.arange(self.nb), n))
        signs = self._char_signs(self._trivial_chars(list(range(n))), d_rep,
                                 n)
        ge_lut = self.sks.generate_lookup_table(lambda x: int(x != 1))
        ge = self.sks.apply_lookup_table_batch(signs, ge_lut)
        m_rep = _take(matched.block, np.zeros(n, dtype=np.int64))
        cond = self.sks.unchecked_bivariate_batch(m_rep, ge,
                                                  self._and_blut())
        new_stack = self._char_zero_if(cond, self._content_stack(s))
        new_len = ik.if_then_else_parallelized(matched, cutoff, len_s)
        return matched, FheString(
            content=[FheAsciiChar(c) for c in self._unstack(new_stack, n)],
            padding=Padding.FINAL, length=new_len)

    # -- padding normalization (ref: change_padding.rs
    #    push_padding_to_end, O(len^2) in the reference) ---------------

    def push_padding_to_end(self, s: FheString) -> FheString:
        """Non-zero chars compacted to the front, padding zeros to the end
        (ref: change_padding.rs push_padding_to_end).

        Two schedules, chosen by where the key lives, as the reference
        chooses by its backend: on a card the compaction by position
        matrix (a few wide PBS batches: a card's lanes are nearly free),
        on the CPU the pairwise zero bubbling (more, narrower batches:
        cheaper where each lane costs compute)."""
        if s.padding in (Padding.NONE, Padding.FINAL) or s.max_len <= 1:
            out = s.copy()
            if out.padding not in (Padding.NONE, Padding.FINAL):
                out.padding = Padding.FINAL
            return out
        if self.sks.device.type == "cpu":
            return self._push_padding_bubble(s)
        return self._push_padding_compact(s)

    def _push_padding_bubble(self, s: FheString) -> FheString:
        """n phases of pairwise zero bubbling (the reference's cmux chains,
        batched a phase)."""
        n = s.max_len
        stack = self._content_stack(s)
        zero_chars = self._trivial_chars([0] * n)
        arr = np.arange(n * self.nb).reshape(n, self.nb)
        for phase in range(n):
            li = list(range(phase % 2, n - 1, 2))
            if not li:
                continue
            ri = [i + 1 for i in li]
            lrows, rrows = arr[li].ravel(), arr[ri].ravel()
            lstack, rstack = _take(stack, lrows), _take(stack, rrows)
            iz = self._char_eq(lstack, _take(zero_chars,
                                             arr[:len(li)].ravel()), len(li))
            new_l = self._char_cmux(iz, rstack, lstack)
            new_r = self._char_zero_if(iz, rstack)
            data = stack.data.clone()
            degs = stack.degrees.copy()
            noise = stack.noise.copy()
            data[_rows(stack, lrows)] = new_l.data
            degs[lrows] = new_l.degrees
            noise[lrows] = new_l.noise
            data[_rows(stack, rrows)] = new_r.data
            degs[rrows] = new_r.degrees
            noise[rrows] = new_r.noise
            stack = ShortintBatch(data, degs, stack.message_modulus,
                                  stack.carry_modulus, noise)
        return FheString(
            content=[FheAsciiChar(c) for c in self._unstack(stack, n)],
            padding=Padding.FINAL,
            length=(s.length if isinstance(s.length, int)
                    else s.length.copy()))

    def _push_padding_compact(self, s: FheString) -> FheString:
        """Each char's target position is the exclusive prefix count of the
        non-padding chars (a log-depth batched scan); one n x n position
        matrix and one batched select move every char to its slot, about
        20 wide PBS batches at any length.  Padding chars add 0 to every
        slot, so they need no mask of their own."""
        n = s.max_len
        sks = self.sks
        nb = self.nb
        ik = self.integer_key
        stack = self._content_stack(s)

        # 1. a non-zero bit per char
        iz = self._char_eq(stack, self._trivial_chars([0] * n), n)
        nz = sks.apply_lookup_table_batch(
            iz, sks.generate_lookup_table(lambda x: 1 - (x % 2)))

        # 2. the exclusive prefix count of non-zeros, a radix value a char
        vals = sks.trivial_batch(np.zeros(n * nb, dtype=_U64), n * nb)
        arr = np.arange(n * nb).reshape(n, nb)
        vals.data[_rows(vals, arr[:, 0])] = nz.data
        vals.degrees[arr[:, 0]] = nz.degrees
        vals.noise[arr[:, 0]] = nz.noise
        # shifted down one char for the exclusive scan
        data = torch.roll(vals.data, nb, dims=0)
        data[:nb] = sks.trivial_batch(np.zeros(nb, dtype=_U64), nb).data
        degs = np.roll(vals.degrees, nb)
        degs[:nb] = 0
        noise = np.roll(vals.noise, nb)
        noise[:nb] = 1
        pos = ShortintBatch(data, degs, vals.message_modulus,
                            vals.carry_modulus, noise)
        d = 1
        while d < n:
            shifted = torch.roll(pos.data, d * nb, dims=0)
            shifted[:d * nb] = 0
            sdegs = np.roll(pos.degrees, d * nb)
            sdegs[:d * nb] = 0
            snoise = np.roll(pos.noise, d * nb)
            snoise[:d * nb] = 1
            prev = ShortintBatch(shifted, sdegs, pos.message_modulus,
                                 pos.carry_modulus, snoise)
            pos, _ = ik.propagate_single_carry(
                sks.unchecked_add_batch(pos, prev), num=n)
            d *= 2

        # 3. the position matrix (pos_i == j) over all n^2 pairs at once
        pos_rep = _take(pos, np.tile(arr, (n, 1)).reshape(-1))  # [n*n*nb]
        js = self._trivial_chars(list(np.repeat(np.arange(n), n)))
        eqm = self._char_eq(pos_rep, js, n * n)            # [n*n], j major

        # 4. batched select: slot j = sum_i char_i * (pos_i == j)
        chars_rep = _take(stack, np.tile(arr.reshape(-1), n))
        cond = _take(eqm, np.repeat(np.arange(n * n), nb))
        pick_lut = sks.generate_lookup_table_bivariate(
            lambda cc, x: x if cc else 0)
        masked = sks.unchecked_bivariate_batch(cond, chars_rep, pick_lut)
        acc = masked.data.reshape(n, n, nb, -1).sum(dim=1).reshape(n * nb, -1)
        summed = ShortintBatch(
            data=acc, degrees=np.full(n * nb, self.msg - 1, dtype=np.int64),
            message_modulus=self.msg, carry_modulus=stack.carry_modulus)
        # a refresh for the noise of the n-way sum
        clean = sks.message_extract_batch(summed)
        return FheString(
            content=[FheAsciiChar(c) for c in self._unstack(clean, n)],
            padding=Padding.FINAL,
            length=(s.length if isinstance(s.length, int)
                    else s.length.copy()))

    # -- replace (char for char; ref: replace.rs) ---------------------

    def replace_char(self, s: FheString, old: Pattern,
                     new: Pattern) -> FheString:
        """Every occurrence of a one-char pattern replaced."""
        ostack, olen, _ = self._pattern_stack(old)
        nstack, nlen, _ = self._pattern_stack(new)
        if olen != 1 or nlen != 1:
            raise ValueError("replace_char expects single chars")
        n = s.max_len
        if n == 0:
            return s.copy()
        s = self._with_final_padding(s)
        stack = self._content_stack(s)
        orep = _take(ostack, np.tile(np.arange(self.nb), n))
        eqs = self._char_eq(stack, orep, n)
        nrep = _take(nstack, np.tile(np.arange(self.nb), n))
        out = self._char_cmux(eqs, nrep, stack)
        return FheString(
            content=[FheAsciiChar(c) for c in self._unstack(out, n)],
            padding=s.padding,
            length=(s.length if isinstance(s.length, int)
                    else s.length.copy()))
