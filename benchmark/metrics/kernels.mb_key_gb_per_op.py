"""kernels.mb_key_gb_per_op: GB of subset-key spectra handed to the
multi-bit combine over the ops of the traced requests, from the program's
counter `fused_multibit.multibit_combine.key_bytes` (a CUDA graph's
replay adds its chain's), its change over each request's root spans:
what the combines read of the key, which the key's primes and planes
size."""

from benchmark.metrics import _program

NAME = "fused_multibit.multibit_combine.key_bytes"


def read(run):
    per = _program.requests(run)
    if per is None or _program.counter(NAME) is None:
        return None
    total = sum(_program.root_count(s, NAME) for s in per)
    return total / 1e9 / _program.ops(run) if total else None
