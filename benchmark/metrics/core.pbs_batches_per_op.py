"""core.pbs_batches_per_op: keyswitch + PBS batches over the ops of the
traced requests, from the program's own counter `pbs.batches` (counted in
`core`; a CUDA graph's replay adds its chain's batches), its change over
each request's root spans."""

from benchmark.metrics import _program


def read(run):
    per = _program.requests(run)
    if per is None:
        return None
    batches = sum(_program.root_count(s, "pbs.batches") for s in per)
    return batches / _program.ops(run)
