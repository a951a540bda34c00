"""core.mb_pbs_batches_per_op: multi-bit keyswitch + PBS batches over the
ops of the traced requests, from the program's counter
`pbs.multibit.batches` (counted in `core`; a CUDA graph's replay adds its
chain's batches), its change over each request's root spans.  None unless
every traced request's count equals the benchmark's own PBS counter's
(`Record.rows`): a program without the counter, or one whose multi-bit
count misses a batch, reports nothing."""

from benchmark.metrics import _program

NAME = "pbs.multibit.batches"


def read(run):
    per = _program.requests(run)
    if per is None:
        return None
    counts = [_program.root_count(s, NAME) for s in per]
    if counts != [len(r.rows) for r in run.traced]:
        return None
    return sum(counts) / _program.ops(run)
