"""The radix ops' single-program schedule: clean-block radix ops through the
chains of `integer/fused.py`, one CUDA graph per (op, shapes) on a card.

Port of `tfhe_tpu/integer/fused_dispatch.py:44-235`.  The degree
bookkeeping that drives the host schedule (ref: integer/server_key/
radix_parallel/) is static for clean blocks, so a whole radix op is one
fixed chain of PBS batches.  The reference traces that chain into one XLA
program per (op, shape) with `jax.jit`; here it is captured once into a
`torch.cuda.CUDAGraph` and replayed, one host launch per op in place of two
per blind-rotation step.  On the CPU the chain runs directly.

Preconditions (`try_op`; None sends the caller to the host schedule, the
reference's own rule for dirty blocks):
- every input block is clean (degree < message_modulus),
- message_modulus >= 4 (the 3-state carry and sign resolves need packing
  room, as IntegerServerKey.propagate_single_carry).

The reference chooses this schedule by the environment variable
TFHE_TPU_FUSED_INTEGER (on by default on a TPU); the port by the argument
`IntegerServerKey(key, fused=True)`.  A capture or replay that fails raises:
nothing drops back to eager launches.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from ..params import PBSOrder
from ..shortint.ciphertext import ShortintBatch
from . import fused as F

CMP_OPS = ("eq", "ne", "lt", "le", "gt", "ge")
BIT_OPS = ("band", "bor", "bxor", "bnot")


class FusedIntegerOps:
    """The single-program radix ops bound to one integer server key: the
    LUT accumulators built once, each (op, shapes) program built once and,
    on a card, captured once into a CUDA graph."""

    def __init__(self, isk):
        self.isk = isk
        self.sks = isk.key
        if self.sks.params.pbs_order is not PBSOrder.KEYSWITCH_BOOTSTRAP:
            # the chains are keyswitch-then-PBS (tfhe_tpu/parallel/
            # fused.py:24); a small-key ciphertext cannot enter them
            raise ValueError("the single-program radix ops need a "
                             "keyswitch-then-bootstrap parameter set")
        self._luts: dict = {}
        self._fns: dict = {}
        self._graphs: dict = {}

    # -- lookup tables ---------------------------------------------------

    def _lut(self, name):
        if name in self._luts:
            return self._luts[name]
        sks = self.sks
        msg = sks.message_modulus
        uni = sks.generate_lookup_table
        biv = sks.generate_lookup_table_bivariate
        if isinstance(name, tuple):  # ("and_sum", c): sum == c
            lut = uni(lambda v, c=name[1]: int(v == c))
        else:
            lut = {
                # carry propagation (ref: radix_parallel/add.rs:518-603)
                "state": lambda: uni(
                    lambda v: 2 if v >= msg else (1 if v == msg - 1 else 0)),
                "resolve": lambda: biv(
                    lambda cur, prev: min(prev if cur == 1 else cur, 2)),
                "carry": lambda: uni(lambda x: 1 if x == 2 else 0),
                "msgext": lambda: uni(lambda x: x % msg),
                "carryext": lambda: uni(lambda x: x // msg),
                # comparator (ref: integer/server_key/comparator.rs:31-60)
                "sign": lambda: biv(
                    lambda x, y: 0 if x == y else (1 if x < y else 2)),
                "sresolve": lambda: biv(
                    lambda high, low: min(low if high == 0 else high, 2)),
                "beq_01": lambda: biv(lambda x, y: int(x == y)),
                "not": lambda: uni(lambda v: int(v == 0)),
                "eq": lambda: uni(lambda s: int(s == 0)),
                "ne": lambda: uni(lambda s: int(s != 0)),
                "lt": lambda: uni(lambda s: int(s == 1)),
                "le": lambda: uni(lambda s: int(s != 2)),
                "gt": lambda: uni(lambda s: int(s == 2)),
                "ge": lambda: uni(lambda s: int(s != 1)),
                # bitwise (ref: radix_parallel/bitwise_op.rs)
                "band": lambda: biv(lambda x, y: x & y),
                "bor": lambda: biv(lambda x, y: x | y),
                "bxor": lambda: biv(lambda x, y: x ^ y),
                "bnot": lambda: uni(lambda x: (msg - 1) - (x % msg)),
                # cmux (ref: radix_parallel/cmux.rs:27)
                "cthen": lambda: biv(lambda c, x: x if c else 0),
                "celse": lambda: biv(lambda c, x: 0 if c else x),
                # sign-driven cmux for max/min (s == 1: lhs < rhs)
                "maxthen": lambda: biv(lambda s, x: x if s != 1 else 0),
                "maxelse": lambda: biv(lambda s, x: x if s == 1 else 0),
                "minthen": lambda: biv(lambda s, x: x if s != 2 else 0),
                "minelse": lambda: biv(lambda s, x: x if s == 2 else 0),
                # multiplication (ref: radix_parallel/mul.rs:329-464)
                "mlsb": lambda: biv(lambda x, y: (x * y) % msg),
                "mmsb": lambda: biv(lambda x, y: (x * y) // msg),
            }[name]()
        self._luts[name] = lut
        return lut

    def _acc(self, name) -> torch.Tensor:
        lut = self._lut(name)
        return lut.acc.acc if hasattr(lut.acc, "acc") else lut.acc

    # -- the per-op programs ---------------------------------------------

    def _fn(self, op: str, shape: tuple):
        """The chain of `op` over inputs of `shape`, every accumulator
        built now (before any capture)."""
        key = (op, shape)
        if key in self._fns:
            return self._fns[key]
        sks = self.sks
        msg, carry, delta = sks.message_modulus, sks.carry_modulus, sks.delta
        kw = dict(message_modulus=msg, mode=sks.mode)
        neg_kw = dict(kw, carry_modulus=carry, delta=delta)
        if op in ("add", "sub", "neg"):
            accs = [self._acc(n)
                    for n in ("state", "resolve", "carry", "msgext")]
            base = {"add": functools.partial(F.fused_radix_add, **kw),
                    "sub": functools.partial(F.fused_radix_sub, **neg_kw),
                    "neg": functools.partial(F.fused_radix_neg, **neg_kw)}[op]
        elif op == "mul":
            accs = [self._acc(n) for n in ("mlsb", "mmsb", "msgext",
                                           "carryext", "state", "resolve",
                                           "carry")]
            base = functools.partial(F.fused_radix_mul, carry_modulus=carry,
                                     **kw)
        elif op in ("eq", "ne"):
            cap = (carry * msg - 1) // (msg - 1)
            and_accs = {c: self._acc(("and_sum", c))
                        for c in F.eq_chunk_widths(shape[0][1], cap)}
            and_accs["not"] = self._acc("not")
            accs = [self._acc("beq_01"), and_accs]
            base = functools.partial(F.fused_radix_eq, negate=op == "ne",
                                     **neg_kw)
        elif op in ("lt", "le", "gt", "ge"):
            accs = [self._acc("sign"), self._acc("sresolve"), self._acc(op)]
            base = functools.partial(F.fused_radix_cmp, **kw)
        elif op in ("band", "bor", "bxor"):
            accs = [self._acc(op)]
            base = functools.partial(F.fused_radix_bitop, **kw)
        elif op == "bnot":
            accs = [self._acc(op)]
            base = functools.partial(F.fused_radix_univariate, mode=sks.mode)
        elif op == "select":
            accs = [self._acc("cthen"), self._acc("celse"),
                    self._acc("msgext")]
            base = functools.partial(F.fused_radix_select, **kw)
        elif op in ("max", "min"):
            accs = [self._acc("sign"), self._acc("sresolve"),
                    self._acc(op + "then"), self._acc(op + "else"),
                    self._acc("msgext")]
            base = functools.partial(F.fused_radix_minmax, **kw)
        else:
            raise KeyError(op)

        def fn(*args):
            return base(sks.ksk, sks.bsk, *accs, *args)

        self._fns[key] = fn
        return fn

    # -- CUDA graphs -------------------------------------------------------

    def _capture(self, key, fn, dev):
        """(static inputs, graph, static output) of fn over inputs shaped
        as dev: one eager warm-up on a side stream (it builds the kernels'
        libraries and tables and cuBLAS's workspace), then the capture."""
        static_in = [d.clone() for d in dev]
        side = torch.cuda.Stream(device=dev[0].device)
        side.wait_stream(torch.cuda.current_stream(dev[0].device))
        try:
            with torch.cuda.stream(side):
                fn(*static_in)
            torch.cuda.current_stream(dev[0].device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                static_out = fn(*static_in)
        except RuntimeError as e:  # torch's CUDA and capture errors
            raise RuntimeError(f"capturing the single-program radix op "
                               f"{key[0]!r} at shapes {key[1]} into a CUDA "
                               f"graph failed (blind-rotation mode "
                               f"{self.sks.mode!r})") from e
        entry = (static_in, graph, static_out)
        self._graphs[key] = entry
        return entry

    def _replay(self, key, fn, dev) -> torch.Tensor:
        entry = self._graphs.get(key) or self._capture(key, fn, dev)
        static_in, graph, static_out = entry
        for s, d in zip(static_in, dev):
            s.copy_(d)
        graph.replay()
        return static_out.clone()  # the next replay overwrites static_out

    # -- block wrapping --------------------------------------------------

    def _clean(self, *batches) -> bool:
        msg = self.sks.message_modulus
        return all(int(b.degrees.max(initial=0)) < msg for b in batches)

    def _wrap(self, out: torch.Tensor, like: ShortintBatch,
              degree: int) -> ShortintBatch:
        arr = out[0]
        if arr.dim() == 1:  # a single boolean block
            arr = arr[None]
        return ShortintBatch(
            data=arr, degrees=np.full(arr.shape[0], degree, dtype=np.int64),
            message_modulus=like.message_modulus,
            carry_modulus=like.carry_modulus)

    # -- public entry ----------------------------------------------------

    def try_op(self, op: str, *args: ShortintBatch,
               graph: Optional[bool] = None) -> Optional[ShortintBatch]:
        """`op` over ShortintBatch args if the preconditions hold, else None
        (the caller takes the host schedule).  On a card the op runs as its
        CUDA graph's replay; graph=False runs the same chain eagerly (the
        graph's check), and a CPU key always runs it directly."""
        sks = self.sks
        msg = sks.message_modulus
        if msg < 4 or not self._clean(*args):
            return None
        dev = [b.data[None] for b in args]  # [1, nb, sz]
        if op == "select":
            dev[0] = dev[0][:, 0, :]  # cond: [1, sz]
        shape = tuple(tuple(d.shape) for d in dev)
        fn = self._fn(op, shape)
        if graph is None:
            graph = sks.device.type == "cuda"
        if graph:
            out = self._replay((op, shape), fn, dev)
        else:
            out = fn(*dev)
        if op in CMP_OPS:
            degree = 1
        elif op in BIT_OPS:
            lut = self._lut(op)
            degree = lut.degree if hasattr(lut, "degree") else lut.acc.degree
        else:
            degree = msg - 1
        return self._wrap(out, args[-1], degree)
