"""pbs_batches_per_op: keyswitch + PBS batches over ops completed in the
window, from the benchmark's PBS counter (a graph replay counts the
batches its capture held)."""


def read(run):
    batches = sum(len(r.rows) for r in run.records)
    return batches / sum(r.ops for r in run.records) if batches else None
