"""pbs_roofline: the least time the card could take for the blind
rotations of the traced slice's PBS batches (benchmark/roofline.py: n
steps a batch at its row count, each step at the larger of its least bytes
over 3.35 TB/s and its least 32-bit operations, with the fewest CRT primes
the parameter set's product needs, over the card's integer peak), as a
percentage of the slice's device-busy time (every device operation,
whatever its name)."""

from benchmark import roofline


def read(run):
    if not run.trace or not run.peaks or run.trace["busy_s"] <= 0:
        return None
    p = run.config["parameters"]
    G = p["glwe_dimension"] + 1
    least = sum(roofline.pbs_batch_min_s(
        rows, p["lwe_dimension"], G, p["pbs_level"], p["polynomial_size"],
        p["pbs_base_log"], run.peaks["int32_ops_per_s"], p["torus_bits"])
        for r in run.traced for rows in r.rows)
    return 100.0 * least / run.trace["busy_s"] if least else None
