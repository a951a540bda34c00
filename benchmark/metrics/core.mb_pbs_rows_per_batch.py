"""core.mb_pbs_rows_per_batch: ciphertexts a multi-bit keyswitch + PBS
batch over the traced requests, the program's counters
`pbs.multibit.rows` over `pbs.multibit.batches` (their changes over each
request's root spans).  None unless every traced request's counts equal
the benchmark's own PBS counter's (`Record.rows`)."""

from benchmark.metrics import _program


def read(run):
    per = _program.requests(run)
    if per is None:
        return None
    batches = [_program.root_count(s, "pbs.multibit.batches") for s in per]
    rows = [_program.root_count(s, "pbs.multibit.rows") for s in per]
    if (batches != [len(r.rows) for r in run.traced]
            or rows != [sum(r.rows) for r in run.traced]):
        return None
    return sum(rows) / sum(batches) if sum(batches) else None
