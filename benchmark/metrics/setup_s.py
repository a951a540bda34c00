"""setup_s: process start to the first timed request (imports, CUDA
context, kernels loaded or built, keys, inputs, warm-up); host clock."""


def read(run):
    return run.setup["setup_s"]
