"""The port's blind rotation on the CPU (the plain versions of its two
kernels, step after step) == tfhe_tpu.core.blind_rotate on the reference's
CRT-NTT path, bit for bit, at the tests/test_fused_pbs.py cases."""

import numpy as np
import pytest

from tfhe_tpu.core import pbs as ref_pbs
from tfhe_tpu.ops.polymul_ntt import prepare_bsk_ntt

from tfhe_tpu_torch import core
from tfhe_tpu_torch.ops.torus import to_numpy, to_tensor
from test_torch_cases import CASES, IDS, rand_inputs


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_blind_rotate_matches_reference(case):
    rng = np.random.default_rng(42)
    n, L, G, N, B = case["n"], case["L"], case["G"], case["N"], case["B"]
    bl, bits = case["bl"], case["bits"]
    bsk_std, lut, lwe = rand_inputs(rng, n, L, G, N, B, bits)
    want = np.asarray(ref_pbs.blind_rotate(prepare_bsk_ntt(bsk_std, bl, bits=bits),
                                           lut, lwe))
    key = core.prepare_bsk_cuda(to_tensor(bsk_std, "cpu"), bl, bits)
    got = core.blind_rotate(key, to_tensor(lut, "cpu"), to_tensor(lwe, "cpu"))
    assert np.array_equal(to_numpy(got, bits), want)
