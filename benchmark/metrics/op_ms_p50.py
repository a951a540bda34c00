"""op_ms_p50: median request latency over the window (host clock)."""

import statistics


def read(run):
    return statistics.median((r.t1 - r.t0) * 1e3 for r in run.records)
