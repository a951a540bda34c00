"""ops_per_s: ops completed in the window over the window's length (from
the first request's start to the last one's completion); host clock.  A
batched request counts its batch, a string request its texts."""


def read(run):
    return sum(r.ops for r in run.records) / run.window_s
