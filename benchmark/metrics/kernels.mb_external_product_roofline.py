"""kernels.mb_external_product_roofline: the least time of the external
products of the traced slice's multi-bit PBS batches, each from the
accumulator with a key a ciphertext (benchmark/roofline_multibit.py
`external_product_work`: n/gf a batch at its row count), as a percentage
of the device time of the kernels named
`multibit_step_cluster_kernel<..., true>` in the trace.  None where the
trace holds no such kernel (another schedule, or a classic
configuration)."""

from benchmark import roofline_multibit as rm


def read(run):
    return rm.kernel_share(run, "external_product",
                           rm.EXTERNAL_PRODUCT_KERNEL)
