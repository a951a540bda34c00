"""mb_pbs_roofline: the least time the card could take for the traced
slice's multi-bit PBS batches (benchmark/roofline_multibit.py: n/gf group
steps a batch at its row count, each at the larger of its least bytes
over 3.35 TB/s and its least 32-bit operations over the card's integer
peak, from the parameter set alone), as a percentage of the slice's
device-busy time (every device operation, whatever its name).  None for
a classic configuration."""

from benchmark import roofline_multibit


def read(run):
    least = roofline_multibit.traced_least_s(run, "step")
    if not least or run.trace["busy_s"] <= 0:
        return None
    return 100.0 * least / run.trace["busy_s"]
