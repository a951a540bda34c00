"""Profiling and observability hooks (port of `tfhe_tpu/utils/profiling.py`).

The reference exposes hot-kernel frames to external profilers via a
`__profiling` cargo feature and measures everything with criterion benches
(ref: tfhe/Cargo.toml:127, fft64/crypto/ggsw.rs:476/600/615 inline(never)
attrs; ci/benchmark_parser.py schema).  The card's equivalents:

- `trace(logdir)`: a `torch.profiler.profile` over the host's activity and,
  where a card is present, the card's (CUPTI), around a block of FHE ops;
  its Chrome trace lands in `logdir` when the block ends (TensorBoard's
  trace handler), and the block gets the profile, whose `key_averages()`
  and `events()` name every kernel and its device time;
- `annotate(name)`: a named region inside a trace
  (`torch.profiler.record_function`);
- `OpTimer`: wall-clock samples per labelled op, emitting the JSON record
  shape of ci/benchmark_parser.py (name, value, unit) so existing
  dashboards ingest it.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from typing import Dict, Iterator, List

import torch


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile a block; its trace is written into `logdir` (view it with
    TensorBoard or chrome://tracing)."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


def annotate(name: str):
    """Named region inside a trace (ref: the __profiling frame markers)."""
    return torch.profiler.record_function(name)


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
