"""The port's CRT-NTT key layout (tfhe_tpu_torch.ops.polymul_ntt, on the
CPU) == tfhe_tpu's (tfhe_tpu/ops/polymul_ntt.py), word for word: one
external product at 32, 64 and 128 bits on the same acc_diff and raw key,
with the reference's MAC stage as jnp ops and as its Pallas kernel
(TFHE_TPU_PALLAS=1, interpret mode); the PreparedBskNtt blind rotation at
the tests/test_fused_pbs.py cases; and the refusals of a schedule the
layout does not run.  (Shortint and boolean keys with mode="ntt":
tests/test_torch_ntt_keys.py.)"""

import numpy as np
import pytest
import torch

from tfhe_tpu.core import pbs as ref_pbs
from tfhe_tpu.ops import polymul_ntt as ref_polymul_ntt

from tfhe_tpu_torch import core
from tfhe_tpu_torch.ops import polymul_ntt, shoup_mac, u128
from tfhe_tpu_torch.ops.torus import to_numpy, to_tensor
from test_torch_cases import CASES, IDS, rand_inputs

# one external product: (bits, L, G, N, base_log), at the three widths'
# decompositions with N cut down (u128: tests/test_u128.py's toy size)
PRODUCTS = [(32, 3, 3, 256, 6), (64, 1, 2, 256, 23), (128, 2, 2, 64, 18)]
PRODUCT_IDS = ["u32", "u64", "u128"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run thousands of small tensor ops; one thread
    each keeps them fast when several test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _words(rng, shape, bits):
    if bits == 128:
        return rng.integers(0, 2**64 - 1, shape + (2,), dtype=np.uint64,
                            endpoint=True)
    dt = np.uint64 if bits == 64 else np.uint32
    return rng.integers(0, np.iinfo(dt).max, shape, dtype=dt, endpoint=True)


@pytest.mark.parametrize("pallas", ["jnp", "pallas"])
@pytest.mark.parametrize("case", PRODUCTS, ids=PRODUCT_IDS)
def test_external_product_matches_reference(case, pallas, monkeypatch):
    if pallas == "pallas":
        monkeypatch.setenv("TFHE_TPU_PALLAS", "1")
    else:
        monkeypatch.delenv("TFHE_TPU_PALLAS", raising=False)
    bits, L, G, N, bl = case
    rng = np.random.default_rng([bits, L, G, N])
    raw = _words(rng, (1, L, G, G, N), bits)
    acc_diff = _words(rng, (4, G, N), bits)
    ref_key = ref_polymul_ntt.prepare_bsk_ntt(raw, bl, bits=bits)
    want = np.asarray(ref_polymul_ntt.external_product_ntt(
        acc_diff, ref_key.spectra[0], ref_key.shoup[0], bl, L, bits=bits,
        fwd_mats=ref_key.fwd_mats, inv_mats=ref_key.inv_mats))
    key = polymul_ntt.prepare_bsk_ntt(raw, bl, bits=bits, device="cpu")
    assert key.spectra.shape == (1, 5, L, G, G, bits // 32, N)
    assert key.shoup.dtype == torch.int32 and key.bits == bits
    diff = (u128.to_tensor(acc_diff, "cpu") if bits == 128
            else to_tensor(acc_diff, "cpu"))
    shoup_mac.reset_launch_counts()
    got = polymul_ntt.external_product_ntt(diff, key.spectra[0],
                                           key.shoup[0], bl, L, bits)
    got = u128.to_numpy(got) if bits == 128 else to_numpy(got, bits)
    assert np.array_equal(got, want)
    assert shoup_mac.shoup_mac.launches == 0  # CPU: the plain version


def test_u128_decomposition_needs_the_high_word_only():
    diff = torch.zeros((1, 2, 64, 2), dtype=torch.int64)
    spec = torch.zeros((5, 3, 2, 2, 4, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match="62"):
        polymul_ntt.external_product_ntt(diff, spec, spec, 21, 3, bits=128)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_blind_rotate_matches_reference(case):
    rng = np.random.default_rng(42)
    n, L, G, N, B = case["n"], case["L"], case["G"], case["N"], case["B"]
    bl, bits = case["bl"], case["bits"]
    bsk_std, lut, lwe = rand_inputs(rng, n, L, G, N, B, bits)
    want = np.asarray(ref_pbs.blind_rotate(
        ref_polymul_ntt.prepare_bsk_ntt(bsk_std, bl, bits=bits), lut, lwe))
    key = core.prepare_bsk_ntt(bsk_std, bl, bits=bits, device="cpu")
    lut_t, lwe_t = to_tensor(lut, "cpu"), to_tensor(lwe, "cpu")
    for mode in (None, "ntt"):
        got = core.blind_rotate(key, lut_t, lwe_t, mode)
        assert np.array_equal(to_numpy(got, bits), want)
    # an all-zero ciphertext rotates by nothing: every update is zero
    assert torch.equal(core.blind_rotate(key, lut_t, torch.zeros_like(lwe_t)),
                       lut_t.expand(B, G, N))


def test_a_schedule_needs_its_own_layout():
    rng = np.random.default_rng(1)
    bsk_std, lut, lwe = rand_inputs(rng, 2, 1, 2, 256, 2, 64)
    ntt_key = core.prepare_bsk_ntt(bsk_std, 23, device="cpu")
    lut_t, lwe_t = to_tensor(lut, "cpu"), to_tensor(lwe, "cpu")
    for mode in ("scan2", "mega", "grid"):
        with pytest.raises(ValueError, match="layout"):
            core.blind_rotate(ntt_key, lut_t, lwe_t, mode)
    for mode in ("bogus", "NTT"):
        with pytest.raises(ValueError, match="mode"):
            core.programmable_bootstrap(ntt_key, lut_t, lwe_t, mode)
    cuda_key = core.prepare_bsk_cuda(to_tensor(bsk_std, "cpu"), 23)
    with pytest.raises(ValueError, match="layout"):
        core.blind_rotate(cuda_key, lut_t, lwe_t, "ntt")
    assert core.CLASSIC_MODES == ("scan2", "scan1", "scan1w", "scan3",
                                  "grid", "mega", "ntt")
    with pytest.raises(ValueError, match="BSK"):
        core.prepare_bsk_ntt(bsk_std[..., :1, :], 23, device="cpu")
