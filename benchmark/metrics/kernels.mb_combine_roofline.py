"""kernels.mb_combine_roofline: the least time of the combines of the
traced slice's multi-bit PBS batches (benchmark/roofline_multibit.py
`combine_work`: n/gf a batch at its row count) as a percentage of the
device time of the kernels named `multibit_combine_kernel` in the trace.
None where the trace holds no such kernel (another schedule, or a
classic configuration)."""

from benchmark import roofline_multibit as rm


def read(run):
    return rm.kernel_share(run, "combine", rm.COMBINE_KERNEL)
