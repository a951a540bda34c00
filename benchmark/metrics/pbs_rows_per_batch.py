"""pbs_rows_per_batch: mean ciphertexts a keyswitch + PBS batch over the
window, from the benchmark's PBS counter."""


def read(run):
    rows = [n for r in run.records for n in r.rows]
    return sum(rows) / len(rows) if rows else None
