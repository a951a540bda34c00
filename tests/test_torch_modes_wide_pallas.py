"""The port's classic blind rotation in the schedules "scan1w" and "mega"
(on the CPU) == tfhe_tpu's own Pallas kernels of the same schedules, K4
`fused_blind_rotate_scan1w` and K7 `fused_blind_rotate_planes`' megakernel,
run in interpret mode on the CPU, bit for bit, at the tests/test_fused_pbs.py
cases.  The reference reads its schedule from TFHE_TPU_FUSED_MODE at call
time (tfhe_tpu/ops/fused_pbs.py:1568); the test sets it around the call.
Its own file, beside test_torch_modes_pallas.py: the interpreted kernels
take most of a worker's minute."""

import numpy as np
import pytest

from tfhe_tpu.ops import fused_pbs as ref_fused

from tfhe_tpu_torch import core
from tfhe_tpu_torch.ops.torus import to_numpy, to_tensor
from test_torch_cases import CASES, IDS, rand_inputs


@pytest.mark.parametrize("mode", ["scan1w", "mega"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_mode_matches_the_reference_pallas_schedule(case, mode, monkeypatch):
    rng = np.random.default_rng(42)
    bl, bits = case["bl"], case["bits"]
    bsk_std, lut, lwe = rand_inputs(rng, *(case[k] for k in "nLGNB"), bits)
    monkeypatch.setenv("TFHE_TPU_FUSED_MODE", mode)
    want = np.asarray(ref_fused.blind_rotate_fused(
        ref_fused.prepare_bsk_fused(bsk_std, bl, bits=bits), lut, lwe))
    key = core.prepare_bsk_cuda(to_tensor(bsk_std, "cpu"), bl, bits)
    got = core.blind_rotate(key, to_tensor(lut, "cpu"), to_tensor(lwe, "cpu"),
                            mode=mode)
    assert np.array_equal(to_numpy(got, bits), want)
