"""Reading a `torch.profiler` trace of the traced slice of a run.

Device operations are the trace's events on the card (kernels, memcpy and
memset), less the annotations that mirror the harness's spans there.  The
busy time is the union of their intervals inside the slice (the
harness's `bench:traced` span); the idle gaps are what is left, each
labelled by the innermost harness span the host was in at the gap's
middle: `request:<kind>` while the program served a request,
`glue:<step>` in the harness's own steps between requests.
"""

from __future__ import annotations

from collections import defaultdict

WINDOW_SPAN = "bench:traced"
SPAN_PREFIXES = ("request:", "glue:")
TOP = 10


def _events(prof):
    """(kind, name, start ns, end ns) of every event; kind "device" for an
    operation on the card, "span" for a harness span on the host, "host"
    for the rest."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        ours = name == WINDOW_SPAN or name.startswith(SPAN_PREFIXES)
        if e.device_type() == DeviceType.CUDA:
            if ours:  # the span's mirror on the card's timeline
                continue
            kind = "device"
        else:
            kind = "span" if ours else "host"
        if hasattr(e, "start_ns"):
            start, dur = e.start_ns(), e.duration_ns()
        else:
            start, dur = e.start_us() * 1000, e.duration_us() * 1000
        out.append((kind, name, start, start + dur))
    return out


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def summarize(prof) -> dict:
    """busy_s, window_s, device_ops (top by summed seconds), idle_gaps
    (the longest, labelled), and the event counts by kind."""
    events = _events(prof)
    windows = [(s, e) for kind, name, s, e in events
               if kind == "span" and name == WINDOW_SPAN]
    if not windows:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN!r} span")
    w0, w1 = windows[0]
    spans = [(s, e, name) for kind, name, s, e in events
             if kind == "span" and name != WINDOW_SPAN]
    by_name = defaultdict(int)
    intervals = []
    kinds = defaultdict(int)
    for kind, name, s, e in events:
        kinds[kind] += 1
        if kind != "device":
            continue
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        by_name[name] += e - s
        intervals.append((s, e))
    merged = _union(intervals)
    busy = sum(e - s for s, e in merged)
    gaps = []
    prev = w0
    for s, e in merged + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)

    def label(t):
        inside = [(e - s, name) for s, e, name in spans if s <= t < e]
        return min(inside)[1] if inside else "host:outside_spans"

    gaps.sort(key=lambda g: g[0] - g[1])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "busy_s": busy / 1e9,
        "window_s": (w1 - w0) / 1e9,
        "device_ops": [[name, ns / 1e9] for name, ns in ops],
        "idle_gaps": [[label((s + e) // 2), (e - s) / 1e9]
                      for s, e in gaps[:TOP]],
        "event_kinds": dict(kinds),
    }
