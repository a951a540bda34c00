"""op_ms_p95: 95th percentile of the window's request latencies (host
clock from the call to the result synchronised on the card)."""

import statistics


def read(run):
    lat = [(r.t1 - r.t0) * 1e3 for r in run.records]
    if len(lat) < 20:
        return None
    return statistics.quantiles(lat, n=20, method="inclusive")[18]
