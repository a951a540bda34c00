"""The clear functions the cells' ops compute, and the control beside them.

`bits` is the integers' precision: the configuration's (64 for FheUint64)
for the reference, and the next one below it (32) for the control, which
puts the clear function at that precision in the program's place.  For
strings `char_bits` plays that part: 8 for ASCII chars, 4 (a nibble) for
the control.  Answers are radix digits, least significant first, or 0/1.
"""

from __future__ import annotations

from typing import List, Sequence

RADIX_OPS = ("add", "sub", "mul", "bitxor", "max", "if_then_else")
BOOL_OPS = ("eq", "lt")


def digits(value: int, num_blocks: int, message_modulus: int) -> List[int]:
    return [(value // message_modulus ** i) % message_modulus
            for i in range(num_blocks)]


def integer_op(op: str, a: int, b: int, cond: bool = False,
               bits: int = 64) -> int:
    """The clear op on unsigned `bits`-bit integers; a comparison gives
    0 or 1, if_then_else a when cond else b."""
    mod = 1 << bits
    a, b = a % mod, b % mod
    if op == "add":
        return (a + b) % mod
    if op == "sub":
        return (a - b) % mod
    if op == "mul":
        return (a * b) % mod
    if op == "bitxor":
        return a ^ b
    if op == "max":
        return max(a, b)
    if op == "if_then_else":
        return a if cond else b
    if op == "eq":
        return int(a == b)
    if op == "lt":
        return int(a < b)
    raise KeyError(op)


def integer_answer(op: str, a: int, b: int, cond: bool, num_blocks: int,
                   message_modulus: int, bits: int = 64) -> List[int]:
    """The answer's blocks: num_blocks digits for a radix op, one 0/1
    block for a comparison."""
    v = integer_op(op, a, b, cond, bits)
    if op in BOOL_OPS:
        return [v]
    return digits(v, num_blocks, message_modulus)


def padded(text: str, max_len: int) -> List[int]:
    """A text's char codes with FINAL padding: zeros up to max_len."""
    codes = [ord(c) for c in text]
    if len(codes) > max_len:
        raise ValueError("text longer than max_len")
    return codes + [0] * (max_len - len(codes))


def match_offsets(codes: Sequence[int], pattern: str,
                  char_bits: int = 8) -> List[int]:
    """0/1 at each offset 0 .. len(codes) - len(pattern): the pattern's
    chars equal the chars there, compared on their low char_bits bits."""
    m = (1 << char_bits) - 1
    pat = [ord(c) & m for c in pattern]
    return [int(all((codes[o + j] & m) == pat[j] for j in range(len(pat))))
            for o in range(len(codes) - len(pat) + 1)]


def contains_answer(text: str, pattern: str, max_len: int,
                    char_bits: int = 8) -> List[int]:
    return [int(any(match_offsets(padded(text, max_len), pattern,
                                  char_bits)))]


def find_answer(text: str, pattern: str, max_len: int,
                char_bits: int = 8) -> List[int]:
    """[found] + the first-match indicator at each offset."""
    hits = match_offsets(padded(text, max_len), pattern, char_bits)
    first = hits.index(1) if 1 in hits else -1
    return [int(first >= 0)] + [int(o == first) for o in range(len(hits))]
