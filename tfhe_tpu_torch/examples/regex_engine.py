"""Regex matching over encrypted strings.

Port of `tfhe_tpu/examples/regex_engine.py` (ref: tfhe/examples/
regex_engine/{parser.rs:1-701, engine.rs:1-263, execution.rs:1-287}).  Same surface:
patterns of the form ``/re/`` (or ``/re/i``) supporting literals, ``.``,
classes ``[a-d]``/``[abc]``/``[^...]``, alternation ``|``, groups,
``?``/``*``/``+``/``{m}``/``{m,n}``, and the anchors ``^``/``$``.

Where the reference lazily builds a ciphertext circuit per AST node with
memoization, this engine compiles the (public) pattern to an
epsilon-free NFA and simulates it over the encrypted text:

- every character-class test runs ONCE for ALL text positions as a single
  batched comparison over the string's block stack;
- each text step evaluates all NFA edges with one batched bivariate PBS
  (edge AND) and all states with one batched threshold PBS (incoming OR),
so the sequential depth is O(len(text)), independent of pattern size.
Block data stays in tensors on the key's device: batches are joined with
`torch.cat` and cut with views or one index tensor; degrees and noise
levels stay numpy bookkeeping, as in the port's `ShortintBatch`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Set, Tuple

import numpy as np
import torch

from ..integer.ciphertext import BooleanBlock
from ..shortint.ciphertext import ShortintBatch
from ..strings.ciphertext import FheString, Padding
from ..strings.server_key import StringServerKey


# ---------------------------------------------------------------------------
# AST + parser (ref: regex_engine/parser.rs)
# ---------------------------------------------------------------------------


@dataclass
class Class:
    """A character class as sorted byte ranges; negated matches complement."""

    ranges: Tuple[Tuple[int, int], ...]
    negated: bool = False

    def case_insensitive(self) -> "Class":
        extra = []
        for lo, hi in self.ranges:
            a, b = max(lo, ord("a")), min(hi, ord("z"))
            if a <= b:
                extra.append((a - 32, b - 32))
            a, b = max(lo, ord("A")), min(hi, ord("Z"))
            if a <= b:
                extra.append((a + 32, b + 32))
        return Class(tuple(sorted(set(self.ranges) | set(extra))),
                     self.negated)


@dataclass
class Seq:
    items: list


@dataclass
class Alt:
    left: object
    right: object


@dataclass
class Rep:
    node: object
    at_least: int
    at_most: Optional[int]  # None = unbounded


ANY = Class(((0, 255),))


class ParseError(ValueError):
    pass


class _Parser:
    def __init__(self, src: str):
        self.src = src
        self.pos = 0

    def peek(self) -> Optional[str]:
        return self.src[self.pos] if self.pos < len(self.src) else None

    def take(self) -> str:
        c = self.peek()
        if c is None:
            raise ParseError("unexpected end of pattern")
        self.pos += 1
        return c

    def parse_alt(self):
        left = self.parse_seq()
        if self.peek() == "|":
            self.take()
            return Alt(left, self.parse_alt())
        return left

    def parse_seq(self):
        items = []
        while self.peek() not in (None, "|", ")"):
            items.append(self.parse_repeat())
        return Seq(items)

    def parse_repeat(self):
        atom = self.parse_atom()
        c = self.peek()
        if c == "?":
            self.take()
            return Rep(atom, 0, 1)
        if c == "*":
            self.take()
            return Rep(atom, 0, None)
        if c == "+":
            self.take()
            return Rep(atom, 1, None)
        if c == "{":
            self.take()
            digits = ""
            while self.peek() and self.peek().isdigit():
                digits += self.take()
            if self.peek() == "}":
                self.take()
                n = int(digits)
                return Rep(atom, n, n)
            if self.peek() == ",":
                self.take()
                hi_digits = ""
                while self.peek() and self.peek().isdigit():
                    hi_digits += self.take()
                if self.take() != "}":
                    raise ParseError("expected }")
                return Rep(atom, int(digits),
                           int(hi_digits) if hi_digits else None)
            raise ParseError("malformed {m,n}")
        return atom

    def parse_atom(self):
        c = self.take()
        if c == "(":
            inner = self.parse_alt()
            if self.take() != ")":
                raise ParseError("expected )")
            return inner
        if c == ".":
            return ANY
        if c == "[":
            return self.parse_class()
        if c == "\\":
            return Class(((ord(self.take()),) * 2,))
        if c in ")|?*+{":
            raise ParseError(f"unexpected {c!r}")
        return Class(((ord(c), ord(c)),))

    def parse_class(self):
        negated = False
        if self.peek() == "^":
            self.take()
            negated = True
        ranges = []
        while self.peek() != "]":
            a = self.take()
            if a == "\\":
                a = self.take()
            if self.peek() == "-" and self.src[self.pos + 1:self.pos + 2] != "]":
                self.take()
                b = self.take()
                if b == "\\":
                    b = self.take()
                ranges.append((ord(a), ord(b)))
            else:
                ranges.append((ord(a), ord(a)))
        self.take()
        return Class(tuple(sorted(ranges)), negated)


def parse_pattern(pattern: str):
    """``/re/`` or ``/re/i`` -> (ast, anchor_start, anchor_end)
    (ref: parser.rs parse — patterns are wrapped in slashes, optional
    case-insensitive flag)."""
    if not pattern.startswith("/"):
        raise ParseError("pattern must start with /")
    ci = False
    if pattern.endswith("/i"):
        body = pattern[1:-2]
        ci = True
    elif pattern.endswith("/"):
        body = pattern[1:-1]
    else:
        raise ParseError("pattern must end with / or /i")
    anchor_start = body.startswith("^")
    if anchor_start:
        body = body[1:]
    anchor_end = body.endswith("$") and not body.endswith("\\$")
    if anchor_end:
        body = body[:-1]
    parser = _Parser(body)
    ast = parser.parse_alt()
    if parser.pos != len(body):
        raise ParseError(f"trailing input at {parser.pos}")
    if ci:
        ast = _case_fold(ast)
    return ast, anchor_start, anchor_end


def _case_fold(node):
    if isinstance(node, Class):
        return node.case_insensitive()
    if isinstance(node, Seq):
        return Seq([_case_fold(i) for i in node.items])
    if isinstance(node, Alt):
        return Alt(_case_fold(node.left), _case_fold(node.right))
    if isinstance(node, Rep):
        return Rep(_case_fold(node.node), node.at_least, node.at_most)
    raise TypeError(node)


# ---------------------------------------------------------------------------
# Thompson NFA with epsilon elimination
# ---------------------------------------------------------------------------


class _Nfa:
    def __init__(self):
        self.n_states = 0
        self.eps: List[Set[int]] = []
        self.edges: List[Tuple[int, int, Class]] = []

    def state(self) -> int:
        self.n_states += 1
        self.eps.append(set())
        return self.n_states - 1

    def add_eps(self, a: int, b: int) -> None:
        self.eps[a].add(b)

    def add_edge(self, a: int, b: int, cls: Class) -> None:
        self.edges.append((a, b, cls))

    def build(self, node, start: int, end: int) -> None:
        if isinstance(node, Class):
            self.add_edge(start, end, node)
        elif isinstance(node, Seq):
            cur = start
            for i, item in enumerate(node.items):
                nxt = end if i == len(node.items) - 1 else self.state()
                self.build(item, cur, nxt)
                cur = nxt
            if not node.items:
                self.add_eps(start, end)
        elif isinstance(node, Alt):
            self.build(node.left, start, end)
            self.build(node.right, start, end)
        elif isinstance(node, Rep):
            cur = start
            for _ in range(node.at_least):
                nxt = self.state()
                self.build(node.node, cur, nxt)
                cur = nxt
            if node.at_most is None:
                loop = self.state()
                self.add_eps(cur, loop)
                self.build(node.node, loop, loop)
                self.add_eps(loop, end)
            else:
                self.add_eps(cur, end)
                for _ in range(node.at_most - node.at_least):
                    nxt = self.state()
                    self.build(node.node, cur, nxt)
                    self.add_eps(nxt, end)
                    cur = nxt
        else:
            raise TypeError(node)

    def closure(self, s: int) -> Set[int]:
        seen = {s}
        stack = [s]
        while stack:
            x = stack.pop()
            for y in self.eps[x]:
                if y not in seen:
                    seen.add(y)
                    stack.append(y)
        return seen


def compile_pattern(pattern: str):
    """-> (start_states, accept_states, edges [(src, dst, class)],
    anchor_start, anchor_end) with epsilon edges eliminated."""
    ast, a_start, a_end = parse_pattern(pattern)
    nfa = _Nfa()
    start = nfa.state()
    end = nfa.state()
    nfa.build(ast, start, end)
    closures = [nfa.closure(s) for s in range(nfa.n_states)]
    accepts = {s for s in range(nfa.n_states) if end in closures[s]}
    start_states = closures[start]
    edges = []
    for (a, b, cls) in nfa.edges:
        for b2 in closures[b]:
            edges.append((a, b2, cls))
    # dedupe identical (src, dst) pairs per class
    edges = list({(a, b, cls.ranges, cls.negated): (a, b, cls)
                  for a, b, cls in edges}.values())
    return start_states, accepts, edges, a_start, a_end


# ---------------------------------------------------------------------------
# encrypted execution (ref: regex_engine/execution.rs — re-shaped for
# batched PBS)
# ---------------------------------------------------------------------------


def has_match(sks: StringServerKey, s: FheString, pattern: str) -> BooleanBlock:
    """Encrypted boolean: does `pattern` match anywhere in `s`?

    Requires an unpadded string (the reference example encrypts without
    padding, ref: regex_engine/ciphertext.rs encrypt_str)."""
    if s.padding != Padding.NONE:
        raise ValueError("regex matching expects an unpadded FheString")
    start_states, accepts, edges, a_start, a_end = compile_pattern(pattern)
    n = s.max_len
    key = sks.sks

    # the two trivial bits, made once on the device (no op writes into a
    # batch, so every use may share them)
    trivial = {v: key.trivial_batch([int(v)], 1) for v in (False, True)}

    def bit(v: bool) -> ShortintBatch:
        return trivial[bool(v)]

    # trivial empty-match shortcut
    if start_states & accepts and not (a_end and n > 0):
        return BooleanBlock(bit(True))
    if n == 0:
        ok = bool(start_states & accepts)
        return BooleanBlock(bit(ok))

    # 1. per-class match bits for every position: one batched range
    #    comparison per range over the whole string
    stack = sks._content_stack(s)
    classes = {}
    for _, _, cls in edges:
        key_cls = (cls.ranges, cls.negated)
        if key_cls in classes:
            continue
        acc = None
        for lo, hi in cls.ranges:
            m = sks._char_range_mask(stack, n, lo, hi)
            acc = m if acc is None else key.unchecked_bivariate_batch(
                acc, m, sks._or_blut())
        if cls.negated:
            not_lut = key.generate_lookup_table(lambda x: 1 - (x % 2))
            acc = key.apply_lookup_table_batch(acc, not_lut)
        classes[key_cls] = acc  # ShortintBatch of n bools

    n_states = 1 + max(max(a for a, _, _ in edges),
                       max(b for _, b, _ in edges),
                       max(start_states | accepts))
    state_bits = [bit(st in start_states) for st in range(n_states)]
    matched = bit(any(st in accepts for st in start_states)
                  and not a_end)

    def saturate(batch: ShortintBatch) -> ShortintBatch:
        lut = key.generate_lookup_table(lambda x: int(x >= 1))
        return key.apply_lookup_table_batch(batch, lut)

    and_blut = sks._and_blut()

    for pos in range(n):
        # 2. all edges in one batched AND: src-state bit x class bit
        srcs = _cat([state_bits[a] for a, _, _ in edges])
        matches = _cat([
            _take(classes[(cls.ranges, cls.negated)], pos)
            for _, _, cls in edges
        ])
        ands = key.unchecked_bivariate_batch(srcs, matches, and_blut)

        # 3. per-destination OR: linear sums + one batched threshold PBS
        sums = []
        for st in range(n_states):
            incoming = [i for i, (_, b, _) in enumerate(edges) if b == st]
            if not incoming:
                sums.append(bit(False))
                continue
            acc = _take(ands, incoming[0])
            for i in incoming[1:]:
                acc = key.unchecked_add_batch(acc, _take(ands, i))
            sums.append(acc)
        new_bits_batch = saturate(_cat(sums))
        state_bits = [_take(new_bits_batch, st) for st in range(n_states)]

        if not a_start:
            # unanchored: re-arm the start states at every position
            for st in start_states:
                state_bits[st] = saturate(
                    key.unchecked_add_batch(state_bits[st], bit(True)))

        accept_now = bit(False)
        for st in accepts:
            accept_now = key.unchecked_add_batch(accept_now, state_bits[st])
        if a_end:
            if pos == n - 1:
                matched = saturate(
                    key.unchecked_add_batch(matched, accept_now))
        else:
            matched = saturate(key.unchecked_add_batch(matched, accept_now))

    return BooleanBlock(matched)


def _cat(batches: List[ShortintBatch]) -> ShortintBatch:
    """The batches' blocks in order: one `torch.cat` on their device."""
    return ShortintBatch(
        data=torch.cat([b.data for b in batches]),
        degrees=np.concatenate([b.degrees for b in batches]),
        message_modulus=batches[0].message_modulus,
        carry_modulus=batches[0].carry_modulus,
        noise=np.concatenate([b.noise for b in batches]),
    )


def _take(b: ShortintBatch, i) -> ShortintBatch:
    """Block i (a view) or blocks i (a list: one index tensor on b's
    device)."""
    if isinstance(i, int):
        rows = slice(i, i + 1)
        data = b.data[rows]
    else:
        rows = np.asarray(i, dtype=np.int64)
        data = b.data[torch.from_numpy(rows).to(b.data.device)]
    return ShortintBatch(
        data=data,
        degrees=b.degrees[rows],
        message_modulus=b.message_modulus,
        carry_modulus=b.carry_modulus,
        noise=b.noise[rows],
    )
