"""Inputs shared by the port's blind-rotation tests: the four
tests/test_fused_pbs.py cases and seeded random keys and ciphertexts for
them.  It holds no tests and imports only numpy, so the card-only tests can
use it without JAX."""

import numpy as np

CASES = [
    dict(n=4, L=1, G=2, N=256, B=8, bl=23, bits=64),
    dict(n=3, L=2, G=2, N=256, B=8, bl=15, bits=64),
    dict(n=4, L=2, G=3, N=512, B=8, bl=8, bits=64),
    dict(n=4, L=2, G=2, N=512, B=8, bl=8, bits=32),
]
IDS = ["n4L1G2N256", "n3L2G2N256", "n4L2G3N512", "n4L2G2N512u32"]


def rand_inputs(rng, n, L, G, N, B, bits=64):
    """Standard-domain BSK [n, L, G, G, N], LUT [G, N], LWE [B, n + 1]."""
    dt = np.uint64 if bits == 64 else np.uint32
    info = np.iinfo(dt)
    bsk = rng.integers(0, info.max, (n, L, G, G, N), dtype=dt)
    lut = rng.integers(0, info.max, (G, N), dtype=dt)
    lwe = rng.integers(0, info.max, (B, n + 1), dtype=dt)
    return bsk, lut, lwe
