"""The port's multi-bit blind rotation (CPU, both schedules) == tfhe_tpu's
fused Pallas kernel K8 (`multi_bit_blind_rotate_fused`, run in interpret
mode on the CPU as tests/test_fused_multibit.py runs it), bit for bit, at
the gf = 3 case of that file.  Its own file: the interpreted kernel takes
most of a worker's time."""

import functools

import numpy as np
import pytest

from tfhe_tpu.ops.fused_multibit import (multi_bit_blind_rotate_fused,
                                         prepare_multi_bit_bsk_fused)

from tfhe_tpu_torch import core
from tfhe_tpu_torch.ops import fused_multibit
from tfhe_tpu_torch.ops.torus import to_numpy, to_tensor

GF, N, L, BL = 3, 256, 1, 15
G, NG, B = 2, 4, 4


@functools.cache
def _inputs_and_pallas_output():
    rng = np.random.default_rng(7)
    mbsk = rng.integers(0, 1 << 64, (NG, 1 << GF, L, G, G, N),
                        dtype=np.uint64)
    lwe = rng.integers(0, 1 << 64, (B, NG * GF + 1), dtype=np.uint64)
    lut = rng.integers(0, 1 << 64, (B, G, N), dtype=np.uint64)
    want = np.asarray(multi_bit_blind_rotate_fused(
        prepare_multi_bit_bsk_fused(mbsk, BL, GF), lut, lwe))
    return mbsk, lwe, lut, want


@pytest.mark.parametrize("mode", fused_multibit.MODES)
def test_blind_rotate_matches_the_pallas_kernel(mode):
    mbsk, lwe, lut, want = _inputs_and_pallas_output()
    key = core.prepare_multi_bit_bsk_cuda(to_tensor(mbsk, "cpu"), BL, GF)
    got = core.multi_bit_blind_rotate(key, to_tensor(lut, "cpu"),
                                      to_tensor(lwe, "cpu"), mode=mode)
    assert np.array_equal(to_numpy(got), want)
