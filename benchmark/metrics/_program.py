"""The program's own spans and counters (`tfhe_tpu_torch.utils.profiling`)
over the traced requests of a run: what the program-span and
program-counter metrics read.

The program records spans while a torch.profiler session runs, which in a
run is the traced slice.  A span's `start_ns` and `end_ns` are
`time.perf_counter_ns()`, the clock of the harness's `Record.t0` / `t1`
(`time.perf_counter()`), so a request's spans are those whose interval
lies inside the request's.  Root spans (no parent) carry the change of
every program counter over them.  A program without spans (no
`profiling.spans`) or a traced request that holds none gives None: the
metric is then left out of the line.
"""

from __future__ import annotations

LAUNCHES = ".launches"
OP_SPANS = ("schedule.fused.", "schedule.batched.")


def requests(run):
    """The program's spans of each traced request, in request order, or
    None."""
    if run is None or not run.traced:
        return None
    try:
        from tfhe_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    if read is None:
        return None
    spans = read()
    out = []
    for r in run.traced:
        lo, hi = r.t0 * 1e9, r.t1 * 1e9
        inside = [s for s in spans if lo <= s.start_ns and s.end_ns <= hi]
        if not inside:
            return None
        out.append(inside)
    return out


def ops(run) -> int:
    return sum(r.ops for r in run.traced)


def root_count(spans, name: str) -> int:
    """The change of counter `name` over the root spans."""
    return sum(s.counts.get(name, 0) for s in spans if s.parent_id is None)


def root_launches(spans) -> int:
    """The change of every registered kernel `launches` counter over the
    root spans."""
    return sum(d for s in spans if s.parent_id is None
               for name, d in s.counts.items() if name.endswith(LAUNCHES))


def ms(span) -> float:
    return (span.end_ns - span.start_ns) / 1e6


def self_ms(spans, parents) -> float:
    """Host ms in the spans `parents` picks less their direct
    children's."""
    chosen = {s.span_id: ms(s) for s in spans if parents(s)}
    for s in spans:
        if s.parent_id in chosen:
            chosen[s.parent_id] -= ms(s)
    return sum(chosen.values())


def counter(name: str):
    """The program's cumulative counter `name`, or None."""
    try:
        from tfhe_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "counters", None)
    return None if read is None else read().get(name)
