"""schedule.graph_pool_mb: the program's counter
`schedule.graph_pool_bytes` (the growth of the allocator's reserved bytes
over each CUDA graph capture, all captured at set-up) in 10^6 bytes,
cumulative over the run; read with the traced slice's spans."""

from benchmark.metrics import _program


def read(run):
    if _program.requests(run) is None:
        return None
    pool = _program.counter("schedule.graph_pool_bytes")
    return None if pool is None else pool / 1e6
