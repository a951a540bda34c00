"""Profiling and observability (port of `tfhe_tpu/utils/profiling.py`).

The reference exposes hot-kernel frames to external profilers via a
`__profiling` cargo feature and measures everything with criterion benches
(ref: tfhe/Cargo.toml:127, fft64/crypto/ggsw.rs:476/600/615 inline(never)
attrs; ci/benchmark_parser.py schema).  The card's equivalents:

- `trace(logdir)`: a `torch.profiler.profile` over the host's activity and,
  where a card is present, the card's (CUPTI), around a block of FHE ops;
  its Chrome trace lands in `logdir` when the block ends (TensorBoard's
  trace handler), and the block gets the profile, whose `key_averages()`
  and `events()` name every kernel and its device time;
- `annotate(name, **attrs)`: the program's span.  The port opens one at
  each layer boundary: `api.<op>` around every public operator,
  `schedule.fused.<op>` (with `schedule.copy_in`, `schedule.replay`,
  `schedule.clone_out`, and once a graph `schedule.capture`) and
  `schedule.batched.<op>` in the radix schedules, `core.pbs` around every
  keyswitch + PBS batch (its `rows` and `mode`, and a multi-bit batch's
  `grouping_factor`); none below a batch;
- counters, always on: each kernel wrapper's `launches` (registered from
  its module's `KERNELS`), `pbs.batches` and `pbs.rows` (every keyswitch +
  PBS batch and its ciphertexts, classic or multi-bit),
  `pbs.multibit.batches` and `pbs.multibit.rows` (the multi-bit ones
  alone), `fused_multibit.multibit_combine.key_bytes` (the subset-key
  spectra each multi-bit combine is handed), and
  `schedule.graph_pool_bytes` (the growth of the allocator's reserved
  bytes over each CUDA graph capture).  A CUDA graph's replay adds the
  change its capture kept, so a replayed op counts as its eager chain;
  `counters()` reads them all;
- `OpTimer`: wall-clock samples per labelled op, emitting the JSON record
  shape of ci/benchmark_parser.py (name, value, unit) so existing
  dashboards ingest it.

The switch is a running `torch.profiler` session (its own enabled flag),
and nothing else.  With none, a span is that one check.  With one, a span
is a profiler range of its name on the trace's clock, beside the kernels
it launched, and a record in a bounded buffer (`spans()`): its name,
`time.perf_counter_ns()` start and end, its id, its parent's and its
root's (one request's spans share the root's), its attrs, and the change
of every counter over it.  The range is a function-scope one
(`torch._C._profiler._RecordFunctionFast`, the Chrome trace's `cpu_op`
category): a `record_function` range is user-scoped, and the profiler
mirrors those onto the card's timeline as `gpu_user_annotation` events,
which a reader of device time would take for device work.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import threading
import time
from collections import defaultdict, deque
from dataclasses import dataclass
from typing import Dict, Iterator, List, Mapping, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

SPAN_BUFFER = 1 << 16  # spans kept; older ones are dropped first
_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile a block; its trace is written into `logdir` (view it with
    TensorBoard or chrome://tracing), and the program's spans inside it
    are kept in `spans()`."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------


class Counter:
    """A count the program keeps; the hot path adds to `value`.  Like the
    wrappers' `launches`, it takes no lock: adds from one thread are
    exact."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0


# name -> (object, attribute) holding the count
_COUNTERS: Dict[str, Tuple[object, str]] = {}


def counter(name: str) -> Counter:
    """A new counter registered under `name`."""
    c = Counter()
    _COUNTERS[name] = (c, "value")
    return c


def register_launches(module: str, kernels) -> None:
    """Registers each wrapper's `launches` as `<module>.<name>.launches`."""
    for fn in kernels:
        _COUNTERS[f"{module}.{fn.__name__}.launches"] = (fn, "launches")


def counters() -> Dict[str, int]:
    """Every registered counter's cumulative value."""
    return {name: getattr(obj, attr)
            for name, (obj, attr) in _COUNTERS.items()}


def changes_since(before: Mapping[str, int]) -> Dict[str, int]:
    """The counters that moved since `before` (a `counters()` reading),
    with their changes."""
    out = {}
    for name, (obj, attr) in _COUNTERS.items():
        d = getattr(obj, attr) - before.get(name, 0)
        if d:
            out[name] = d
    return out


def add_counts(changes: Mapping[str, int]) -> None:
    """Adds `changes` (name -> amount) to the counters."""
    for name, d in changes.items():
        obj, attr = _COUNTERS[name]
        setattr(obj, attr, getattr(obj, attr) + d)


SPANS_DROPPED = counter("profiling.spans_dropped")


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Span:
    """One recorded span; `counts` holds the registered counters that
    moved over it (in any thread), with their changes."""

    name: str
    start_ns: int
    end_ns: int
    span_id: int
    parent_id: Optional[int]
    root_id: int
    attrs: Mapping[str, object]
    counts: Mapping[str, int]


_BUFFER: deque = deque(maxlen=SPAN_BUFFER)
_IDS = itertools.count(1)
_LOCAL = threading.local()


def _stack() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


class _Span:
    __slots__ = ("name", "attrs", "span_id", "parent_id", "root_id",
                 "before", "start", "range")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = _stack()
        self.span_id = next(_IDS)
        if stack:
            self.parent_id, self.root_id = stack[-1].span_id, stack[-1].root_id
        else:
            self.parent_id, self.root_id = None, self.span_id
        stack.append(self)
        self.before = counters()
        self.range = torch._C._profiler._RecordFunctionFast(self.name)
        self.range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.perf_counter_ns()
        self.range.__exit__(*exc)
        _stack().pop()
        if len(_BUFFER) == SPAN_BUFFER:
            SPANS_DROPPED.value += 1
        _BUFFER.append(Span(self.name, self.start, end, self.span_id,
                            self.parent_id, self.root_id, self.attrs,
                            changes_since(self.before)))
        return False


def annotate(name: str, **attrs):
    """The program's span `name` around a block (a context manager): a
    profiler range and a record in `spans()` while a torch.profiler
    session runs, nothing otherwise (ref: the __profiling frame
    markers)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, attrs)


def spanned(name: str):
    """`annotate(name)` around every call of the decorated function."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _autograd_profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _Span(name, {}):
                return fn(*args, **kwargs)
        return inner
    return wrap


def spans() -> Tuple[Span, ...]:
    """The recorded spans, oldest first (at most SPAN_BUFFER)."""
    return tuple(_BUFFER)


# ---------------------------------------------------------------------------
# OpTimer
# ---------------------------------------------------------------------------


class OpTimer:
    """Wall-clock accounting per labelled operation.

    Kernels are launched asynchronously: a block on the card returns once
    its launches are queued.  So once CUDA is initialised, `measure` ends
    with `torch.cuda.synchronize()`, and a sample holds the block's device
    work, not only its launches."""

    def __init__(self):
        self._samples: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def measure(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
            self._samples[name].append(time.perf_counter() - t0)

    def records(self) -> List[dict]:
        """criterion/benchmark_parser-style records
        (ref: ci/benchmark_parser.py:40-60)."""
        out = []
        for name, samples in sorted(self._samples.items()):
            mean = sum(samples) / len(samples)
            out.append({
                "name": name,
                "value": mean * 1e3,
                "unit": "ms",
                "samples": len(samples),
                "min_ms": min(samples) * 1e3,
                "max_ms": max(samples) * 1e3,
                "ops_per_sec": (1.0 / mean) if mean > 0 else None,
            })
        return out

    def dump_json(self) -> str:
        return "\n".join(json.dumps(r) for r in self.records())
