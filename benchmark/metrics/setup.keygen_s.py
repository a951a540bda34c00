"""setup.keygen_s: the program's client and server keys made on the
benchmark's secret key (bootstrapping and keyswitching keys generated and
prepared for the kernels); host clock, synchronised."""


def read(run):
    return run.setup["keygen_s"]
