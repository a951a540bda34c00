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

Counting (`utils.profiling`): the eager warm-up before a capture ran on the
card and counts; the captured pass ran nothing, so its counters' change
(PBS batches and rows, kernel launches) is taken back and kept with the
graph, and every replay adds it again: a replayed op counts as its eager
chain.  `schedule.graph_pool_bytes` grows by each capture's growth of the
allocator's reserved bytes.  Spans: `schedule.fused.<op>` around an op,
with `schedule.copy_in`, `schedule.replay` and `schedule.clone_out`;
`schedule.capture` once a graph, with `schedule.capture.eager` and
`schedule.capture.record`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..params import PBSOrder
from ..shortint.ciphertext import ShortintBatch
from ..utils import profiling
from . import fused as F

CMP_OPS = ("eq", "ne", "lt", "le", "gt", "ge")
BIT_OPS = ("band", "bor", "bxor", "bnot")
# bytes the allocator reserved over each capture: the graphs' memory pools
GRAPH_POOL_BYTES = profiling.counter("schedule.graph_pool_bytes")


class FusedIntegerOps:
    """The single-program radix ops bound to one integer server key: each
    (op, shapes) chain of `integer.fused` bound once (`_radix_op`) and, on
    a card, captured once into a CUDA graph."""

    def __init__(self, isk):
        self.isk = isk
        self.sks = isk.key
        if self.sks.params.pbs_order is not PBSOrder.KEYSWITCH_BOOTSTRAP:
            # the chains are keyswitch-then-PBS (tfhe_tpu/parallel/
            # fused.py:24); a small-key ciphertext cannot enter them
            raise ValueError("the single-program radix ops need a "
                             "keyswitch-then-bootstrap parameter set")
        self._pbs = F._pbs_on(self.sks.ksk, self.sks.bsk, self.sks.mode)
        self._fns: dict = {}
        self._graphs: dict = {}
        self._graph_counts: dict = {}  # key -> its captured pass's counts

    def _fn(self, op: str, shape: tuple):
        """The chain of `op` over inputs of `shape`, every accumulator
        built now (before any capture)."""
        key = (op, shape)
        if key not in self._fns:
            self._fns[key] = F._radix_op(self.sks, op, shape[-1][1],
                                         self._pbs)
        return self._fns[key]

    # -- CUDA graphs -------------------------------------------------------

    def _capture(self, key, fn, dev):
        """(static inputs, graph, static output) of fn over inputs shaped
        as dev: one eager warm-up on a side stream (it builds the kernels'
        libraries and tables and cuBLAS's workspace), then the capture.
        The captured pass's counts are taken back and kept for the
        replays."""
        static_in = [d.clone() for d in dev]
        device = dev[0].device
        side = torch.cuda.Stream(device=device)
        side.wait_stream(torch.cuda.current_stream(device))
        try:
            with profiling.annotate("schedule.capture", op=key[0]):
                with profiling.annotate("schedule.capture.eager"), \
                        torch.cuda.stream(side):
                    fn(*static_in)
                torch.cuda.current_stream(device).wait_stream(side)
                graph = torch.cuda.CUDAGraph()
                with profiling.annotate("schedule.capture.record"):
                    before = profiling.counters()
                    with torch.cuda.graph(graph):
                        # reserved after the capture's own emptying of
                        # the cache: the growth is the graph's pool
                        reserved = torch.cuda.memory_reserved(device)
                        static_out = fn(*static_in)
                    kept = profiling.changes_since(before)
                    profiling.add_counts({k: -v for k, v in kept.items()})
                GRAPH_POOL_BYTES.value += (torch.cuda.memory_reserved(device)
                                           - reserved)
        except RuntimeError as e:  # torch's CUDA and capture errors
            raise RuntimeError(f"capturing the single-program radix op "
                               f"{key[0]!r} at shapes {key[1]} into a CUDA "
                               f"graph failed (blind-rotation mode "
                               f"{self.sks.mode!r})") from e
        entry = (static_in, graph, static_out)
        self._graphs[key] = entry
        self._graph_counts[key] = kept
        return entry

    def _replay(self, key, fn, dev) -> torch.Tensor:
        entry = self._graphs.get(key) or self._capture(key, fn, dev)
        static_in, graph, static_out = entry
        with profiling.annotate("schedule.copy_in"):
            for s, d in zip(static_in, dev):
                s.copy_(d)
        with profiling.annotate("schedule.replay"):
            graph.replay()
            profiling.add_counts(self._graph_counts[key])
        with profiling.annotate("schedule.clone_out"):
            # the next replay overwrites static_out
            return static_out.clone()

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
        with profiling.annotate(f"schedule.fused.{op}"):
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
                degree = F._lut(sks, op).degree
            else:
                degree = msg - 1
            return self._wrap(out, args[-1], degree)
