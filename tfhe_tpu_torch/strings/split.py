"""The split family and replace over encrypted strings.

Port of `tfhe_tpu/strings/split.py` (ref: tfhe/examples/fhe_strings/
server_key/{split.rs, rsplit.rs, rsplitn.rs, split_terminator.rs,
split_inclusive.rs, split_ascii_whitespace.rs, replace.rs}).  The reference
builds each part with sequential passes over the offsets; here every stage
is a batched PBS round over stacked characters:

1. prefix-match vector over all offsets (one fused batch),
2. greedy non-overlapping separator selection -- a no-op for stride-1
   patterns, a prefix-count filter for limited stride-1 (splitn with a
   char), and a short sequential sweep with an encrypted countdown only
   when the stride is > 1 or itself encrypted,
3. radix prefix-counts by Hillis-Steele scan give every position its part
   index,
4. one batched equality over all (part, position) pairs scatters the
   characters of every part simultaneously, and grouped count scans give
   all part lengths.

`FheSplit` follows the reference contract (split.rs:9-17): entries of
`parts` beyond `number_parts` are garbage and must be ignored.

Known divergence from the Rust library, kept from the reference: an
*encrypted* pattern that decrypts to the empty string is treated as a
1-char stride (the Rust library special-cases `*_allow_empty_pattern`);
clear empty patterns follow Rust `str` semantics exactly.

As in `server_key.py`, the blocks stay on the key's device and the writes
the reference makes in place go into tensors the op made itself.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ..integer.ciphertext import BooleanBlock, RadixCiphertext
from ..integer.server_key import _concat, _gather
from ..shortint.ciphertext import ShortintBatch
from .ciphertext import FheAsciiChar, FheSplit, FheString, Padding

_U64 = np.uint64

Pattern = Union[str, bytes, int, "FheAsciiChar", FheString]
Count = Union[int, RadixCiphertext]


class SplitOps:
    """Mixin for StringServerKey (relies on its stacked-char machinery)."""

    # ------------------------------------------------------------------
    # small radix helpers over position stacks
    # ------------------------------------------------------------------

    def _trivial_radix_stack(self, values, nbp: int) -> ShortintBatch:
        msg = self.msg
        digits = []
        for v in values:
            digits.extend((int(v) // msg**j) % msg for j in range(nbp))
        return self.sks.trivial_batch(np.asarray(digits, dtype=_U64),
                                      len(values) * nbp)

    def _widen_bits(self, bits: ShortintBatch, nbp: int) -> ShortintBatch:
        """[n] 0/1 blocks -> [n*nbp] radix stacks (bit in block 0)."""
        n = len(bits)
        out = self.sks.trivial_batch(np.zeros(n * nbp, dtype=_U64), n * nbp)
        idx = np.arange(n) * nbp
        data = out.data.clone()
        degs, noise = out.degrees.copy(), out.noise.copy()
        data[torch.from_numpy(idx).to(data.device)] = bits.data
        degs[idx] = bits.degrees
        noise[idx] = bits.noise
        return ShortintBatch(data, degs, out.message_modulus,
                             out.carry_modulus, noise)

    def _radix_of_bool(self, bb: BooleanBlock) -> RadixCiphertext:
        return RadixCiphertext(self._widen_bits(bb.block, self.nb))

    def _group_prefix_count(self, bits: ShortintBatch, num: int = 1,
                            reverse: bool = False) -> ShortintBatch:
        """Inclusive per-position prefix count (within each of `num` groups)
        of a 0/1 block vector, as nb-block radix integers [len(bits)*nb].

        Hillis-Steele scan of radix adds: log2(group) rounds, each one
        batched add + carry propagation (ref analogue:
        radix_parallel/add.rs:572 prefix machinery, here over counts)."""
        nb = self.nb
        total = len(bits)
        glen = total // num
        w = self._widen_bits(bits, nb)
        ik = self.integer_key
        d = 1
        while d < glen:
            if reverse:
                prev = ik._shift_blocks_down(w, d * nb, num=num)
            else:
                prev = ik._shift_blocks_up(w, d * nb, num=num)
            s = self.sks.unchecked_add_batch(w, prev)
            w, _ = ik.propagate_single_carry(s, num=total)
            d *= 2
        return w

    def _shift_bits(self, bits: ShortintBatch, d: int,
                    reverse: bool = False) -> ShortintBatch:
        """Position shift with zero fill (new[i]=old[i-d]; reverse: old[i+d])."""
        ik = self.integer_key
        return (ik._shift_blocks_down(bits, d) if reverse
                else ik._shift_blocks_up(bits, d))

    def _stack_cmp_lut(self, op: str):
        table = {"eq": lambda x: int(x == 0), "ne": lambda x: int(x != 0),
                 "lt": lambda x: int(x == 1), "le": lambda x: int(x != 2),
                 "gt": lambda x: int(x == 2), "ge": lambda x: int(x != 1)}
        return self.sks.generate_lookup_table(table[op])

    def _stack_cmp(self, a_stack: ShortintBatch, b_stack: ShortintBatch,
                   num: int, op: str) -> ShortintBatch:
        """[num] 0/1 blocks comparing radix groups of a vs b."""
        signs = self._char_signs(a_stack, b_stack, num)
        return self.sks.apply_lookup_table_batch(signs, self._stack_cmp_lut(op))

    def _not_bits(self, bits: ShortintBatch) -> ShortintBatch:
        lut = self.sks.generate_lookup_table(lambda x: 1 - (x % 2))
        return self.sks.apply_lookup_table_batch(bits, lut)

    def _ones(self, n: int) -> ShortintBatch:
        return self.sks.trivial_batch(np.ones(n, dtype=_U64), n)

    # ------------------------------------------------------------------
    # separator selection
    # ------------------------------------------------------------------

    def _pattern_len(self, pattern: Pattern):
        """Clear length, or the pattern's encrypted length radix."""
        if isinstance(pattern, FheString) and pattern.is_encrypted_length():
            return pattern.length
        if isinstance(pattern, FheString):
            return pattern.length
        if isinstance(pattern, (FheAsciiChar, int)):
            return 1
        data = pattern.encode("ascii") if isinstance(pattern, str) else pattern
        return len(data)

    def _select_matches(
        self, matches: ShortintBatch, stride, limit=None,
        reverse: bool = False,
    ) -> Tuple[ShortintBatch, ShortintBatch]:
        """Greedy non-overlapping match selection.

        stride: clear int >= 1 or encrypted RadixCiphertext (clamped >= 1).
        limit: optional clear int / RadixCiphertext cap on #selections.
        Returns (sel [n], free-at-entry [n]) 0/1 block vectors.
        (ref: split.rs keeps per-offset overlap bookkeeping; here one
        sweep with an encrypted countdown, or no sweep at all for the
        common stride-1 case.)"""
        ik = self.integer_key
        sks = self.sks
        n = len(matches)
        if isinstance(stride, int) and stride == 1:
            ones = self._ones(n)
            if limit is None:
                return matches, ones
            # all matches selected in order until the budget runs out:
            # sel[i] = match[i] AND (#matches before i, in scan order) < limit
            cnt = self._group_prefix_count(
                self._shift_bits(matches, 1, reverse=reverse),
                reverse=reverse)
            if isinstance(limit, int):
                lim_stack = self._trivial_radix_stack([limit] * n, self.nb)
            else:
                lim_stack = self._take(limit.blocks,
                                       np.tile(np.arange(self.nb), n))
            ok = self._stack_cmp(cnt, lim_stack, n, "lt")
            sel = sks.unchecked_bivariate_batch(matches, ok, self._and_blut())
            return sel, ones
        # sequential sweep with encrypted countdown state
        zero = ik.create_trivial_radix(0, self.nb)
        if isinstance(stride, int):
            lm1 = ik.create_trivial_radix(stride - 1, self.nb)
        else:
            is0 = ik.scalar_eq_parallelized(stride, 0)
            lm1 = ik.if_then_else_parallelized(
                is0, zero, ik.scalar_sub_parallelized(stride, 1))
        r = None
        if limit is not None:
            r = (ik.create_trivial_radix(limit, self.nb)
                 if isinstance(limit, int) else limit.copy())
        c = zero.copy()
        order = range(n - 1, -1, -1) if reverse else range(n)
        sel_parts: List[Optional[ShortintBatch]] = [None] * n
        free_parts: List[Optional[ShortintBatch]] = [None] * n
        for i in order:
            free = ik.scalar_eq_parallelized(c, 0)
            ok = ik.boolean_bitand(free, BooleanBlock(self._take(matches, [i])))
            if r is not None:
                has = ik.scalar_cmp_parallelized(r, 0, "gt")
                ok = ik.boolean_bitand(ok, has)
            sel_parts[i] = ok.block
            free_parts[i] = free.block
            cm1 = ik.scalar_sub_parallelized(c, 1)
            dec = ik.if_then_else_parallelized(free, zero, cm1)
            c = ik.if_then_else_parallelized(ok, lm1, dec)
            if r is not None:
                r = ik.sub_parallelized(r, self._radix_of_bool(ok))
        return self._cat_b(sel_parts), self._cat_b(free_parts)

    def _cat_b(self, parts) -> ShortintBatch:
        return _concat(list(parts))

    def _take(self, b: ShortintBatch, idx) -> ShortintBatch:
        return _gather(b, idx)

    def _consumed(self, sel: ShortintBatch, free: ShortintBatch, stride,
                  reverse: bool) -> ShortintBatch:
        """[n] 0/1: position is inside a selected separator."""
        sks = self.sks
        n = len(sel)
        if not reverse:
            # forward sweep: consumed = sel OR NOT free-at-entry
            blut = sks.generate_lookup_table_bivariate(
                lambda s, f: int(bool(s) or not f))
            return sks.unchecked_bivariate_batch(sel, free, blut)
        if isinstance(stride, int):
            c = sel
            for d in range(1, stride):
                c = sks.unchecked_bivariate_batch(
                    c, self._shift_bits(sel, d), self._or_blut())
            return c
        # reverse greedy + encrypted stride: forward countdown sweep
        ik = self.integer_key
        zero = ik.create_trivial_radix(0, self.nb)
        c = zero.copy()
        out: List[ShortintBatch] = []
        for i in range(n):
            s_i = BooleanBlock(self._take(sel, [i]))
            c_eff = ik.if_then_else_parallelized(s_i, stride, c)
            consumed = ik.scalar_cmp_parallelized(c_eff, 0, "gt")
            is0 = ik.boolean_bitnot(consumed)
            c = ik.if_then_else_parallelized(
                is0, zero, ik.scalar_sub_parallelized(c_eff, 1))
            out.append(consumed.block)
        return self._cat_b(out)

    # ------------------------------------------------------------------
    # part construction
    # ------------------------------------------------------------------

    def _nonzero_chars(self, stack: ShortintBatch, n: int) -> ShortintBatch:
        zeros = self._trivial_chars([0] * n)
        return self._not_bits(self._char_eq(stack, zeros, n))

    def _scatter_parts(self, stack: ShortintBatch, n: int,
                       keep: ShortintBatch, part_ids: ShortintBatch,
                       max_parts: int
                       ) -> Tuple[List[FheString], ShortintBatch]:
        """Build all parts at once.  part j char i = (keep[i] AND
        part_ids[i]==j) ? s[i] : 0.  Returns (parts, kept-indicator
        [max_parts*n] used for lengths/emptiness)."""
        sks = self.sks
        nb = self.nb
        reps = np.tile(np.arange(n * nb), max_parts)
        a = self._take(part_ids, reps)
        b = self._trivial_radix_stack(np.repeat(np.arange(max_parts), n), nb)
        ind = self._char_eq(a, b, max_parts * n)
        k_t = self._take(keep, np.tile(np.arange(n), max_parts))
        ind = sks.unchecked_bivariate_batch(ind, k_t, self._and_blut())
        chars = self._take(stack, np.tile(np.arange(n * nb), max_parts))
        cond = self._take(ind, np.repeat(np.arange(max_parts * n), nb))
        keep_lut = sks.generate_lookup_table_bivariate(
            lambda cc, x: x if cc else 0)
        out = sks.unchecked_bivariate_batch(cond, chars, keep_lut)
        # lengths: grouped inclusive count, last position of each group
        lens = self._group_prefix_count(ind, num=max_parts)
        parts: List[FheString] = []
        for g in range(max_parts):
            content = self._unstack(
                self._take(out, np.arange(g * n * nb, (g + 1) * n * nb)), n)
            top = (g * n + n - 1) * nb
            length = RadixCiphertext(
                self._take(lens, np.arange(top, top + nb)))
            parts.append(FheString(
                content=[FheAsciiChar(c) for c in content],
                padding=Padding.ANYWHERE, length=length))
        return parts, ind

    def _num_sel_radix(self, sel: ShortintBatch) -> RadixCiphertext:
        return self._bools_count(sel)

    def _part_nonempty(self, kept: ShortintBatch, part_ids: ShortintBatch,
                       n: int, which: RadixCiphertext) -> BooleanBlock:
        """OR_i (keep[i] AND part_ids[i] == which)  (both encrypted)."""
        w_t = self._take(which.blocks, np.tile(np.arange(self.nb), n))
        ind = self._char_eq(part_ids, w_t, n)
        both = self.sks.unchecked_bivariate_batch(ind, kept, self._and_blut())
        return self._bool_fold(both, "or")

    def _empty_fhe_string(self) -> FheString:
        return FheString(content=[], padding=Padding.NONE, length=0)

    # ------------------------------------------------------------------
    # the generic split engine
    # ------------------------------------------------------------------

    def _split_engine(self, s: FheString, pattern: Pattern,
                      limit: Optional[Count] = None, reverse: bool = False,
                      terminator: bool = False, inclusive: bool = False
                      ) -> FheSplit:
        ik = self.integer_key
        sks = self.sks
        s = self._with_final_padding(s)
        n = s.max_len
        plen = self._pattern_len(pattern)
        if isinstance(plen, int) and plen == 0:
            return self._split_empty_pattern(s, limit=limit, reverse=reverse,
                                             terminator=terminator,
                                             inclusive=inclusive)
        if n == 0:
            if terminator or inclusive:
                return FheSplit([], ik.create_trivial_radix(0, self.nb))
            num = (ik.create_trivial_radix(1, self.nb) if limit is None
                   else self._clamp_single_part(limit))
            return FheSplit([self._empty_fhe_string()], num)

        matches = self._prefix_matches(s, pattern, list(range(n)))
        eff_limit = limit
        if limit is not None and isinstance(limit, int):
            eff_limit = max(limit - 1, 0)
        elif limit is not None:
            is0 = ik.scalar_eq_parallelized(limit, 0)
            eff_limit = ik.if_then_else_parallelized(
                is0, ik.create_trivial_radix(0, self.nb),
                ik.scalar_sub_parallelized(limit, 1))
        stride = plen
        sel, free = self._select_matches(matches, stride, limit=eff_limit,
                                         reverse=reverse)
        stack = self._content_stack(s)
        nonzero = self._nonzero_chars(stack, n)
        num_sel = self._num_sel_radix(sel)

        if inclusive:
            part_ids = self._group_prefix_count(self._shift_bits(sel, 1))
            notfree = self._not_bits(free)
            part_ids = self._sub_stacks(
                part_ids, self._widen_bits(notfree, self.nb), n)
            keep = nonzero
        else:
            consumed = self._consumed(sel, free, stride, reverse)
            keep = sks.unchecked_bivariate_batch(
                nonzero, consumed,
                sks.generate_lookup_table_bivariate(
                    lambda nz, co: int(bool(nz) and not co)))
            part_ids = self._group_prefix_count(
                self._shift_bits(sel, 1, reverse=reverse), reverse=reverse)

        adjust_down = None
        if terminator and reverse:
            # rsplit_terminator drops the (rightmost) part 0 when empty:
            # subtract 1 from every part id (safe: no kept id is 0 then)
            zero = ik.create_trivial_radix(0, self.nb)
            first_nonempty = self._part_nonempty(keep, part_ids, n, zero)
            adjust_down = ik.boolean_bitnot(first_nonempty)
            bit = self._take(adjust_down.block, np.zeros(n, dtype=np.int64))
            part_ids = self._sub_stacks(
                part_ids, self._widen_bits(bit, self.nb), n)

        max_parts = n + 1
        parts, kept = self._scatter_parts(stack, n, keep, part_ids, max_parts)

        one = ik.create_trivial_radix(1, self.nb)
        if inclusive:
            last_nonempty = self._part_nonempty(keep, part_ids, n, num_sel)
            number_parts = ik.add_parallelized(
                num_sel, self._radix_of_bool(last_nonempty))
        elif terminator and not reverse:
            last_nonempty = self._part_nonempty(keep, part_ids, n, num_sel)
            number_parts = ik.add_parallelized(
                num_sel, self._radix_of_bool(last_nonempty))
        elif terminator and reverse:
            number_parts = ik.add_parallelized(num_sel, one)
            number_parts = ik.sub_parallelized(
                number_parts, self._radix_of_bool(adjust_down))
        else:
            number_parts = ik.add_parallelized(num_sel, one)
            if limit is not None and not isinstance(limit, int):
                is0 = ik.scalar_eq_parallelized(limit, 0)
                number_parts = ik.if_then_else_parallelized(
                    is0, ik.create_trivial_radix(0, self.nb), number_parts)
            elif isinstance(limit, int) and limit == 0:
                number_parts = ik.create_trivial_radix(0, self.nb)
        return FheSplit(parts, number_parts)

    def _clamp_single_part(self, limit: Count) -> RadixCiphertext:
        ik = self.integer_key
        if isinstance(limit, int):
            return ik.create_trivial_radix(min(limit, 1), self.nb)
        is0 = ik.scalar_eq_parallelized(limit, 0)
        return ik.if_then_else_parallelized(
            is0, ik.create_trivial_radix(0, self.nb),
            ik.create_trivial_radix(1, self.nb))

    # ------------------------------------------------------------------
    # clear empty pattern (Rust `str` semantics: matches at every char
    # boundary; ref split.rs:245-347 split_*_empty_pattern)
    # ------------------------------------------------------------------

    def _split_empty_pattern(self, s: FheString, limit: Optional[Count],
                             reverse: bool, terminator: bool,
                             inclusive: bool) -> FheSplit:
        ik = self.integer_key
        n = s.max_len
        len_r = self._length_radix(s)
        if limit is not None and not isinstance(limit, int):
            return self._split_empty_pattern_enc_limit(s, limit, reverse)
        if inclusive or terminator:
            # parts = the chars themselves ("ab" -> ["a","b"])
            parts = [FheString([FheAsciiChar(c.ct.copy())],
                               padding=Padding.FINAL,
                               length=self._char_len_bit(s, j))
                     for j, c in enumerate(s.content)]
            if reverse:  # rsplit_terminator: reversed char order
                parts = self._gather_reversed_chars(s)
            return FheSplit(parts, len_r.copy())
        k = limit
        max_mid = n if k is None else max(min(k - 2, n), 0)
        parts: List[FheString] = [self._empty_fhe_string()]
        if not reverse:
            for j in range(max_mid):
                parts.append(FheString([FheAsciiChar(s.content[j].ct.copy())],
                                       padding=Padding.FINAL,
                                       length=self._char_len_bit(s, j)))
        else:
            parts.extend(self._gather_reversed_chars(s, upto=max_mid))
        if k is None:
            parts.append(self._empty_fhe_string())
            number_parts = ik.scalar_add_parallelized(len_r, 2)
            return FheSplit(parts, number_parts)
        if k == 0:
            return FheSplit([], ik.create_trivial_radix(0, self.nb))
        if k == 1:
            return FheSplit([s.copy()], ik.create_trivial_radix(1, self.nb))
        # last part = remainder (chars k-2.. for split, prefix for rsplit)
        rest = self._empty_pattern_rest(s, k - 2, reverse)
        parts = parts[:k - 1] + [rest]
        np_full = ik.scalar_add_parallelized(len_r, 2)
        k_r = ik.create_trivial_radix(k, self.nb)
        over = ik.scalar_cmp_parallelized(np_full, k, "gt")
        number_parts = ik.if_then_else_parallelized(over, k_r, np_full)
        return FheSplit(parts, number_parts)

    def _split_empty_pattern_enc_limit(self, s: FheString,
                                       k: RadixCiphertext, reverse: bool
                                       ) -> FheSplit:
        """splitn/rsplitn with an ENCRYPTED count and a clear empty pattern.

        Rust semantics (ref split.rs:245-347, rsplitn.rs): split("") yields
        len+2 parts ["", c_0, .., c_{len-1}, ""], and splitn(k, "") keeps
        the first k-1 of those then the remainder.  With k encrypted the
        parts list is the static maximum (n+2 entries); entries beyond
        number_parts = (k==0 ? 0 : min(len+2, k)) are garbage per the
        FheSplit contract.  Part j in 1..n is the single char when
        j < k-1 and the remainder (suffix for split, prefix for rsplit)
        when j == k-1 — encoded as the static char slice with every
        position past the first masked by the is-remainder bit."""
        ik = self.integer_key
        sks = self.sks
        n = s.max_len
        nb = self.nb
        len_r = self._length_radix(s)
        zero = ik.create_trivial_radix(0, self.nb)

        # number_parts = min(len + 2, k); the k == 0 case falls out (min=0)
        full = ik.scalar_add_parallelized(len_r, 2)
        k_lt = ik.lt_parallelized(k, full)
        number_parts = ik.if_then_else_parallelized(k_lt, k, full)

        keep_lut = sks.generate_lookup_table_bivariate(
            lambda cc, x: x if cc else 0)

        # part 0: the whole string when k == 1, else ""
        k1 = ik.scalar_eq_parallelized(k, 1)
        if n:
            stack = self._content_stack(s)
            bit0 = self._take(k1.block, np.zeros(n * nb, dtype=np.int64))
            p0 = sks.unchecked_bivariate_batch(bit0, stack, keep_lut)
            part0_content = [FheAsciiChar(c) for c in self._unstack(p0, n)]
        else:
            part0_content = []
        len0 = ik.if_then_else_parallelized(k1, len_r, zero)
        parts = [FheString(content=part0_content, padding=Padding.ANYWHERE,
                           length=len0)]

        if n:
            # is_rest[j-1] = (k == j + 1) for parts j = 1..n, one batch
            a = self._trivial_radix_stack(range(2, n + 2), nb)
            b = self._take(k.blocks, np.tile(np.arange(nb), n))
            is_rest = self._char_eq(a, b, n)

            if reverse:
                # part j char slot t holds s[t], kept iff
                #   is_rest: t + (j-1) < len  (prefix remainder)
                #   else:    t + j == len     (the single rsplit char)
                # cond = eq OR (is_rest AND lt), three bivariate batches
                pairs = [(j, t) for j in range(1, n + 1)
                         for t in range(n - j + 1)]
                P = len(pairs)
                bl = self._take(len_r.blocks, np.tile(np.arange(nb), P))
                eq = self._char_eq(
                    self._trivial_radix_stack([t + j for j, t in pairs], nb),
                    bl, P)
                lt = self._stack_cmp(
                    self._trivial_radix_stack(
                        [t + j - 1 for j, t in pairs], nb), bl, P, "lt")
                rest_rep = self._take(
                    is_rest, np.asarray([j - 1 for j, _ in pairs]))
                both = sks.unchecked_bivariate_batch(
                    rest_rep, lt, self._and_blut())
                cond = sks.unchecked_bivariate_batch(eq, both,
                                                     self._or_blut())
                chars = self._take(stack, np.asarray(
                    [t * nb + d for _, t in pairs for d in range(nb)]))
                body = sks.unchecked_bivariate_batch(
                    self._take(cond, np.repeat(np.arange(P), nb)),
                    chars, keep_lut)
            else:
                # part j = static suffix s[j-1:]; slot t >= 1 is masked by
                # is_rest (single-char parts keep only the leading char)
                pairs = [(j, t) for j in range(1, n + 1)
                         for t in range(1, n - j + 1)]
                if pairs:
                    blk = np.asarray([(j - 1 + t) * nb + d
                                      for j, t in pairs for d in range(nb)])
                    cond = self._take(
                        is_rest, np.repeat([j - 1 for j, _ in pairs], nb))
                    tails = sks.unchecked_bivariate_batch(
                        cond, self._take(stack, blk), keep_lut)

            pos = 0
            for j in range(1, n + 1):
                is_rest_j = BooleanBlock(self._take(is_rest, [j - 1]))
                # length: remainder size when is_rest, else the 0/1 char bit
                under = ik.scalar_cmp_parallelized(len_r, j - 1, "le")
                rem = ik.if_then_else_parallelized(
                    under, zero, ik.scalar_sub_parallelized(len_r, j - 1))
                lj = ik.if_then_else_parallelized(
                    is_rest_j, rem, self._char_len_bit(s, j - 1))
                m = len([1 for jj, _ in pairs if jj == j])
                if reverse:
                    content = [FheAsciiChar(c) for c in self._unstack(
                        self._take(body,
                                   np.arange(pos * nb, (pos + m) * nb)), m)]
                else:
                    head = RadixCiphertext(self._take(
                        stack, np.arange((j - 1) * nb, j * nb)))
                    tail_cts = (self._unstack(
                        self._take(tails,
                                   np.arange(pos * nb, (pos + m) * nb)), m)
                        if m else [])
                    content = [FheAsciiChar(head)] + [
                        FheAsciiChar(c) for c in tail_cts]
                pos += m
                parts.append(FheString(content=content,
                                       padding=Padding.ANYWHERE, length=lj))
        parts.append(self._empty_fhe_string())
        return FheSplit(parts, number_parts)

    def _char_len_bit(self, s: FheString, j: int) -> RadixCiphertext:
        """length (0/1) of the single-char part at index j: j < len(s)."""
        ik = self.integer_key
        if isinstance(s.length, int):
            return ik.create_trivial_radix(int(j < s.length), self.nb)
        gt = ik.scalar_cmp_parallelized(s.length, j, "gt")
        return self._radix_of_bool(gt)

    def _gather_reversed_chars(self, s: FheString,
                               upto: Optional[int] = None) -> List[FheString]:
        """Parts j=1.. : the char at encrypted index len - j (rsplit order).

        One batched equality over all (j, i) pairs: part j keeps char i
        iff i + j == len(s)."""
        n = s.max_len
        m = n if upto is None else upto
        if m == 0:
            return []
        len_r = self._length_radix(s)
        pairs = [(j, i) for j in range(1, m + 1) for i in range(n)]
        a = self._trivial_radix_stack([i + j for j, i in pairs], self.nb)
        b = self._take(len_r.blocks,
                       np.tile(np.arange(self.nb), len(pairs)))
        ind = self._char_eq(a, b, len(pairs))
        stack = self._content_stack(s)
        chars = self._take(stack, np.tile(np.arange(n * self.nb), m))
        cond = self._take(ind, np.repeat(np.arange(len(pairs)), self.nb))
        keep_lut = self.sks.generate_lookup_table_bivariate(
            lambda cc, x: x if cc else 0)
        out = self.sks.unchecked_bivariate_batch(cond, chars, keep_lut)
        parts = []
        for j in range(m):
            content = self._unstack(
                self._take(out, np.arange(j * n * self.nb,
                                          (j + 1) * n * self.nb)), n)
            parts.append(FheString(
                content=[FheAsciiChar(c) for c in content],
                padding=Padding.ANYWHERE,
                length=self._char_len_bit(s, j)))
        return parts

    def _empty_pattern_rest(self, s: FheString, skip: int, reverse: bool
                            ) -> FheString:
        """Remainder part for splitn with empty pattern: drop `skip` chars
        from the front (split) or back (rsplit)."""
        ik = self.integer_key
        n = s.max_len
        len_r = self._length_radix(s)
        under = ik.scalar_cmp_parallelized(len_r, skip, "le")
        rem = ik.if_then_else_parallelized(
            under, ik.create_trivial_radix(0, self.nb),
            ik.scalar_sub_parallelized(len_r, skip))
        if not reverse:
            content = [FheAsciiChar(c.ct.copy()) for c in s.content[skip:]]
            return FheString(content=content, padding=Padding.ANYWHERE,
                             length=rem)
        # rsplit: keep chars i with i < len - skip
        stack = self._content_stack(s)
        a = self._trivial_radix_stack([i + skip for i in range(n)], self.nb)
        b = self._take(len_r.blocks, np.tile(np.arange(self.nb), n))
        keep = self._stack_cmp(a, b, n, "lt")
        cond = self._take(keep, np.repeat(np.arange(n), self.nb))
        keep_lut = self.sks.generate_lookup_table_bivariate(
            lambda cc, x: x if cc else 0)
        out = self.sks.unchecked_bivariate_batch(cond, stack, keep_lut)
        return FheString(
            content=[FheAsciiChar(c) for c in self._unstack(out, n)],
            padding=Padding.ANYWHERE, length=rem)

    # ------------------------------------------------------------------
    # public split API (ref file:fn listed per method)
    # ------------------------------------------------------------------

    def split(self, s: FheString, pattern: Pattern) -> FheSplit:
        """(ref: split.rs:37 split; dispatches clear/encrypted patterns)"""
        return self._split_engine(s, pattern)

    def rsplit(self, s: FheString, pattern: Pattern) -> FheSplit:
        """(ref: rsplit.rs:12 rsplit)"""
        return self._split_engine(s, pattern, reverse=True)

    def splitn(self, s: FheString, n: Count, pattern: Pattern) -> FheSplit:
        """At most n parts; n clear or encrypted (ref: split.rs:97-201)."""
        return self._split_engine(s, pattern, limit=n)

    def rsplitn(self, s: FheString, n: Count, pattern: Pattern) -> FheSplit:
        """(ref: rsplitn.rs:9-54)"""
        return self._split_engine(s, pattern, limit=n, reverse=True)

    def split_terminator(self, s: FheString, pattern: Pattern) -> FheSplit:
        """Trailing empty part dropped (ref: split_terminator.rs)."""
        return self._split_engine(s, pattern, terminator=True)

    def rsplit_terminator(self, s: FheString, pattern: Pattern) -> FheSplit:
        """(ref: rsplit.rs:17 rsplit_terminator)"""
        return self._split_engine(s, pattern, reverse=True, terminator=True)

    def split_inclusive(self, s: FheString, pattern: Pattern) -> FheSplit:
        """Separator kept at the end of each part (ref: split_inclusive.rs:8)."""
        return self._split_engine(s, pattern, inclusive=True)

    def split_ascii_whitespace(self, s: FheString) -> FheSplit:
        """Maximal runs of non-whitespace; no empty parts
        (ref: split_ascii_whitespace.rs)."""
        ik = self.integer_key
        sks = self.sks
        s = self._with_final_padding(s)
        n = s.max_len
        if n == 0:
            return FheSplit([], ik.create_trivial_radix(0, self.nb))
        stack = self._content_stack(s)
        ws = self._is_ws_or_zero(stack, n)
        keep = self._not_bits(ws)
        prev_ws = self._shift_bits(ws, 1)
        # boundary: position 0 has no predecessor -> treat as whitespace
        # (prev_ws is a fresh concatenation: the write stays in it)
        prev_ws.data[0:1] = self._ones(1).data
        prev_ws.degrees[0:1] = 1
        run_start = sks.unchecked_bivariate_batch(keep, prev_ws,
                                                  self._and_blut())
        cnt = self._group_prefix_count(run_start)  # inclusive; part = cnt-1
        part_ids = self._sub_stacks(
            cnt, self._widen_bits(self._ones(n), self.nb), n)
        max_parts = (n + 1) // 2 + 1
        parts, _ = self._scatter_parts(stack, n, keep, part_ids, max_parts)
        number_parts = self._num_sel_radix(run_start)
        return FheSplit(parts, number_parts)

    # ------------------------------------------------------------------
    # replace / replacen = split + conditional join (ref: replace.rs:20-111
    # replace/replacen via insert_in_fhe_split_result_padded_anywhere)
    # ------------------------------------------------------------------

    def replace(self, s: FheString, old: Pattern, new: Pattern) -> FheString:
        """Replace every non-overlapping occurrence of `old` with `new`."""
        return self._replace_engine(s, old, new, limit=None)

    def replacen(self, s: FheString, old: Pattern, new: Pattern,
                 count: Count) -> FheString:
        """Replace the first `count` occurrences (clear or encrypted count)."""
        ik = self.integer_key
        if isinstance(count, int):
            limit: Count = count + 1
        else:
            limit = ik.scalar_add_parallelized(count, 1)
        return self._replace_engine(s, old, new, limit=limit)

    def _replace_engine(self, s: FheString, old: Pattern, new: Pattern,
                        limit: Optional[Count]) -> FheString:
        ik = self.integer_key
        sks = self.sks
        sp = (self._split_engine(s, old) if limit is None
              else self._split_engine(s, old, limit=limit))
        # new as a stacked char block + its length
        nstack, nlen, _ = self._pattern_stack(new)
        if isinstance(new, FheString):
            new_len_r = self._length_radix(self._with_final_padding(new))
        else:
            new_len_r = ik.create_trivial_radix(nlen, self.nb)
        mp = len(sp.parts)
        num = sp.number_parts
        # indicator stacks: drop_part[j] = (number_parts <= j),
        #                   drop_sep[j]  = (number_parts <= j+1)
        num_t = self._take(num.blocks, np.tile(np.arange(self.nb), mp))
        j_t = self._trivial_radix_stack(np.arange(mp), self.nb)
        j1_t = self._trivial_radix_stack(np.arange(1, mp + 1), self.nb)
        drop_part = self._stack_cmp(num_t, j_t, mp, "le")
        drop_sep = self._stack_cmp(num_t, j1_t, mp, "le")
        pieces: List[ShortintBatch] = []
        for j, part in enumerate(sp.parts):
            pn = part.max_len
            if pn:
                pstack = self._content_stack(part)
                cond = self._take(drop_part, np.full(pn, j, dtype=np.int64))
                pieces.append(self._char_zero_if(cond, pstack))
            if j < mp - 1 and nlen:
                cond = self._take(drop_sep, np.full(nlen, j, dtype=np.int64))
                piece = self._take(nstack, np.arange(nlen * self.nb))
                pieces.append(self._char_zero_if(cond, piece))
        out = _concat(pieces)
        width = len(out) // self.nb
        # result length = len(s) + num_rep*(len(new) - len(old))
        num_rep = ik.sub_parallelized(
            num, ik.create_trivial_radix(1, self.nb))
        old_len = self._pattern_len(old)
        if isinstance(old_len, int):
            old_len_r = ik.create_trivial_radix(old_len, self.nb)
        else:
            old_len_r = old_len
        len_s = self._length_radix(s)
        add_t = ik.mul_parallelized(num_rep, new_len_r)
        sub_t = ik.mul_parallelized(num_rep, old_len_r)
        length = ik.sub_parallelized(ik.add_parallelized(len_s, add_t), sub_t)
        return FheString(
            content=[FheAsciiChar(c) for c in self._unstack(out, width)],
            padding=Padding.ANYWHERE, length=length)
