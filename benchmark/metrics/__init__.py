"""Metric readers: `benchmark/metrics/<metric>.py` defines `read(run)`,
which returns the metric's value from a `harness.Run`, or None where the
run holds nothing to read (the harness then leaves the metric out)."""
