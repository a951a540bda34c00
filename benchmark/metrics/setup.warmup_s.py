"""setup.warmup_s: the traffic's own request kinds served `warmup_rounds`
times before the window (graph captures, first launches); host clock."""


def read(run):
    return run.setup["warmup_s"]
