"""kernels.launches_per_op: kernel launches over the ops of the traced
requests, every registered `launches` counter of the program (a CUDA
graph's replay adds its chain's launches), their changes over each
request's root spans.  0 where the plain PyTorch versions ran (the
CPU)."""

from benchmark.metrics import _program


def read(run):
    per = _program.requests(run)
    if per is None:
        return None
    return sum(_program.root_launches(s) for s in per) / _program.ops(run)
