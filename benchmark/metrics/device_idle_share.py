"""device_idle_share: 1 - (union of device-operation intervals) / the
traced slice's length, from torch.profiler (benchmark/devtrace.py)."""


def read(run):
    t = run.trace
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 1.0 - t["busy_s"] / t["window_s"]
