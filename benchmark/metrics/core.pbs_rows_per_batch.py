"""core.pbs_rows_per_batch: ciphertexts a keyswitch + PBS batch over the
traced requests, the program's counters `pbs.rows` over `pbs.batches`
(their changes over each request's root spans)."""

from benchmark.metrics import _program


def read(run):
    per = _program.requests(run)
    if per is None:
        return None
    batches = sum(_program.root_count(s, "pbs.batches") for s in per)
    rows = sum(_program.root_count(s, "pbs.rows") for s in per)
    return rows / batches if batches else None
