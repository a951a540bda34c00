"""Signed radix integers: two's complement over the radix modulus.

Port of `tfhe_tpu/integer/signed.py` (ref: tfhe/src/integer/ciphertext/
mod.rs SignedRadixCiphertext; radix_parallel/{abs.rs, shift.rs arithmetic
right shift, div_mod.rs signed_div_rem, comparison.rs signed comparisons,
add.rs/sub.rs signed_overflowing_*}), with the same PBS batches in the same
order.

Two's-complement semantics make add/sub/neg/mul(low)/bitwise/rotate/left
shift identical to the unsigned block algorithms; this mixin adds the ops
whose behavior differs: sign-aware comparisons (flip the top block's MSB
and compare unsigned), arithmetic right shift (logical shift OR'd with a
sign-selected high mask), absolute value, signed truncating division, and
signed overflow detection.
"""

from __future__ import annotations

from typing import Tuple

from ..shortint.ciphertext import ShortintBatch
from .ciphertext import BooleanBlock, RadixCiphertext


class SignedRadixCiphertext(RadixCiphertext):
    """Same block layout as RadixCiphertext; interpreted two's complement."""

    def copy(self) -> "SignedRadixCiphertext":
        return SignedRadixCiphertext(self.blocks.copy())


def _as_signed(ct: RadixCiphertext) -> SignedRadixCiphertext:
    return SignedRadixCiphertext(ct.blocks)


class SignedOps:
    """Mixin for IntegerServerKey."""

    # -- sign machinery ------------------------------------------------

    def _top_block(self, a: RadixCiphertext) -> ShortintBatch:
        nb = a.num_blocks
        return ShortintBatch(
            data=a.blocks.data[nb - 1:nb], degrees=a.blocks.degrees[nb - 1:nb],
            message_modulus=a.blocks.message_modulus,
            carry_modulus=a.blocks.carry_modulus,
            noise=a.blocks.noise[nb - 1:nb])

    def sign_bit_parallelized(self, a: RadixCiphertext) -> BooleanBlock:
        """1 iff a < 0 (MSB of the top block)."""
        msg = self._msg
        lut = self.key.generate_lookup_table(lambda x: int(x >= msg // 2))
        return BooleanBlock(
            self.key.apply_lookup_table_batch(self._top_block(a), lut))

    def _flip_msb(self, a: RadixCiphertext) -> RadixCiphertext:
        """XOR the sign bit: maps signed order onto unsigned order
        (ref: comparator.rs signed comparisons)."""
        msg = self._msg
        lut = self.key.generate_lookup_table(lambda x: (x + msg // 2) % msg)
        top = self.key.apply_lookup_table_batch(self._top_block(a), lut)
        nb = a.num_blocks
        data = a.blocks.data.clone()
        degs = a.blocks.degrees.copy()
        noise = a.blocks.noise.copy()
        data[nb - 1:nb] = top.data
        degs[nb - 1:nb] = top.degrees
        noise[nb - 1:nb] = top.noise
        return RadixCiphertext(ShortintBatch(
            data, degs, a.blocks.message_modulus, a.blocks.carry_modulus,
            noise))

    # -- comparisons (eq/ne are sign-agnostic; order ops flip MSBs) ----

    def signed_cmp_parallelized(self, a: RadixCiphertext, b: RadixCiphertext,
                                op: str) -> BooleanBlock:
        if op in ("eq", "ne"):
            return getattr(self, f"{op}_parallelized")(a, b)
        fa, fb = self._flip_msb(a), self._flip_msb(b)
        return getattr(self, f"{op}_parallelized")(fa, fb)

    def signed_scalar_cmp_parallelized(self, a: RadixCiphertext, scalar: int,
                                       op: str) -> BooleanBlock:
        t = self.create_trivial_radix(scalar, a.num_blocks)
        return self.signed_cmp_parallelized(a, t, op)

    def signed_max_parallelized(self, a, b) -> SignedRadixCiphertext:
        ge = self.signed_cmp_parallelized(a, b, "ge")
        return _as_signed(self.if_then_else_parallelized(ge, a, b))

    def signed_min_parallelized(self, a, b) -> SignedRadixCiphertext:
        le = self.signed_cmp_parallelized(a, b, "le")
        return _as_signed(self.if_then_else_parallelized(le, a, b))

    # -- abs (ref: radix_parallel/abs.rs:36 abs_parallelized) ----------

    def abs_parallelized(self, a: RadixCiphertext) -> SignedRadixCiphertext:
        neg = self.sign_bit_parallelized(a)
        return _as_signed(self.if_then_else_parallelized(
            neg, self.neg_parallelized(a), a))

    # -- arithmetic right shift ----------------------------------------
    # logical shift leaves the top `shift` bits zero; the sign mask has
    # ones exactly there, so a bitwise OR completes the sign extension
    # (ref: radix_parallel/scalar_shift.rs signed branch, shift.rs)

    def signed_scalar_right_shift_parallelized(self, a: RadixCiphertext,
                                               shift: int
                                               ) -> SignedRadixCiphertext:
        nb = a.num_blocks
        nbits = nb * self._bits_per_block()
        shift %= nbits
        u = self.scalar_right_shift_parallelized(a, shift)
        if shift == 0:
            return _as_signed(u)
        mask_val = ((1 << shift) - 1) << (nbits - shift)
        return self._or_sign_mask(u, self.sign_bit_parallelized(a),
                                  self.create_trivial_radix(mask_val, nb))

    def signed_right_shift_parallelized(self, a: RadixCiphertext,
                                        amount: RadixCiphertext
                                        ) -> SignedRadixCiphertext:
        nb = a.num_blocks
        u = self.right_shift_parallelized(a, amount)
        ones = self.create_trivial_radix(-1, nb)
        low = self.right_shift_parallelized(ones, amount)
        mask = self.bitnot(low)
        return self._or_sign_mask(u, self.sign_bit_parallelized(a), mask)

    def _or_sign_mask(self, u: RadixCiphertext, sign: BooleanBlock,
                      mask: RadixCiphertext) -> SignedRadixCiphertext:
        zero = self.create_trivial_radix(0, u.num_blocks)
        masked = self.if_then_else_parallelized(sign, mask, zero)
        return _as_signed(self.bitor_parallelized(u, masked))

    # -- signed division: truncation toward zero via |a| / |b|
    # (ref: radix_parallel/div_mod.rs signed_div_rem_parallelized) ------

    def signed_div_rem_parallelized(
        self, a: RadixCiphertext, b: RadixCiphertext
    ) -> Tuple[SignedRadixCiphertext, SignedRadixCiphertext]:
        sa = self.sign_bit_parallelized(a)
        sb = self.sign_bit_parallelized(b)
        qa = self.abs_parallelized(a)
        qb = self.abs_parallelized(b)
        q, r = self.div_rem_parallelized(qa, qb)
        qs = self.boolean_bitxor(sa, sb)
        q_signed = self.if_then_else_parallelized(qs, self.neg_parallelized(q),
                                                  q)
        r_signed = self.if_then_else_parallelized(sa, self.neg_parallelized(r),
                                                  r)
        return _as_signed(q_signed), _as_signed(r_signed)

    def signed_div_parallelized(self, a, b) -> SignedRadixCiphertext:
        return self.signed_div_rem_parallelized(a, b)[0]

    def signed_rem_parallelized(self, a, b) -> SignedRadixCiphertext:
        return self.signed_div_rem_parallelized(a, b)[1]

    # -- signed overflow detection (ref: add.rs signed_overflowing_add,
    # sub.rs signed_overflowing_sub) ------------------------------------

    def signed_overflowing_add_parallelized(self, a: RadixCiphertext,
                                            b: RadixCiphertext):
        s = self.key.unchecked_add_batch(a.blocks, b.blocks)
        clean, _ = self.propagate_single_carry(s)
        res = SignedRadixCiphertext(clean)
        sa = self.sign_bit_parallelized(a)
        sb = self.sign_bit_parallelized(b)
        sr = self.sign_bit_parallelized(res)
        same_in = self.boolean_bitnot(self.boolean_bitxor(sa, sb))
        flipped = self.boolean_bitxor(sr, sa)
        return res, self.boolean_bitand(same_in, flipped)

    def signed_overflowing_sub_parallelized(self, a: RadixCiphertext,
                                            b: RadixCiphertext):
        res = _as_signed(self.sub_parallelized(a, b))
        sa = self.sign_bit_parallelized(a)
        sb = self.sign_bit_parallelized(b)
        sr = self.sign_bit_parallelized(res)
        diff_in = self.boolean_bitxor(sa, sb)
        flipped = self.boolean_bitxor(sr, sa)
        return res, self.boolean_bitand(diff_in, flipped)

    # -- signed scalar div/rem by a clear constant (ref:
    # scalar_div_mod.rs signed_scalar_div_rem_parallelized) -------------

    def signed_scalar_div_rem_parallelized(self, a: RadixCiphertext, d: int):
        if d == 0:
            raise ZeroDivisionError("signed scalar division by zero")
        sa = self.sign_bit_parallelized(a)
        qa = self.abs_parallelized(a)
        q = self.scalar_div_parallelized(qa, abs(d))
        r = self.sub_parallelized(qa, self.scalar_mul_parallelized(q, abs(d)))
        qs = self.boolean_bitxor(sa, self.create_trivial_bool(d < 0))
        q_signed = self.if_then_else_parallelized(qs, self.neg_parallelized(q),
                                                  q)
        r_signed = self.if_then_else_parallelized(sa, self.neg_parallelized(r),
                                                  r)
        return _as_signed(q_signed), _as_signed(r_signed)
