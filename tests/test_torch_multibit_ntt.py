"""Multi-bit keys in mode="ntt", the CRT-NTT key layout (tfhe_tpu_torch,
on the CPU), at PARAM_MULTI_BIT_MESSAGE_2_CARRY_2_GROUP_2_TEST: the blind
rotation == tfhe_tpu's `multi_bit_blind_rotate(prepare_multi_bit_bsk_ntt(
...))` (its layout whenever it is not on a TPU) word for word, and == the
port's scan3 on the same raw key; shortint LUTs in both PBS orders ==
tfhe_tpu's shortint key; a LUT and an add through a mode="ntt" key; the
layout refusing the kernels' modes and the kernels' layout refusing
"ntt"."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfhe_tpu import shortint as ref_shortint
from tfhe_tpu.core import multibit as ref_multibit
from tfhe_tpu.params import EncryptionKeyChoice as RefKeyChoice
from tfhe_tpu.params import (
    PARAM_MULTI_BIT_MESSAGE_2_CARRY_2_GROUP_2_TEST as REF_PARAMS)

from tfhe_tpu_torch import core, shortint, weights
from tfhe_tpu_torch.ops import ntt
from tfhe_tpu_torch.ops.torus import to_numpy, to_tensor
from tfhe_tpu_torch.params import EncryptionKeyChoice
from tfhe_tpu_torch.params import (
    PARAM_MULTI_BIT_MESSAGE_2_CARRY_2_GROUP_2_TEST as PARAMS)

SEED = 41
MSGS = np.arange(16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _params(order):
    if order == "ks_pbs":
        return REF_PARAMS, PARAMS
    return (dataclasses.replace(REF_PARAMS,
                                encryption_key_choice=RefKeyChoice.SMALL),
            dataclasses.replace(PARAMS,
                                encryption_key_choice=EncryptionKeyChoice.SMALL))


@functools.cache
def _keys(order):
    ref_p, p = _params(order)
    rc, rs = ref_shortint.gen_keys(ref_p, seed=SEED)
    c, s = shortint.gen_keys(p, seed=SEED, device="cpu", mode="ntt")
    return rc, rs, c, s


def test_monomial_spectra_are_the_monomials_transforms():
    N = PARAMS.polynomial_size
    d = torch.tensor([0, 1, 5, N - 1, N, N + 3, 2 * N - 1])
    mono = torch.zeros((len(d), N), dtype=torch.int64)
    for i, e in enumerate(d.tolist()):
        mono[i, e % N] = 1 if e < N else -1
    assert torch.equal(ntt.monomial_spectra(d, N), ntt.forward_ntt(mono))


def test_rotation_matches_reference_and_scan3():
    rc, rs, _, s = _keys("ks_pbs")
    assert isinstance(s.bsk, core.PreparedMultiBitBskNtt) and s.mode == "ntt"
    p = PARAMS
    rng = np.random.default_rng(7)
    B, n = 6, p.lwe_dimension
    lwe = rng.integers(0, 1 << 64, (B, n + 1), dtype=np.uint64)
    lut = rng.integers(0, 1 << 64, (B, p.glwe_size, p.polynomial_size),
                       dtype=np.uint64)
    ref_key = ref_multibit.prepare_multi_bit_bsk_ntt(
        np.asarray(rs.raw_bsk), p.pbs_base_log, p.grouping_factor)
    want = np.asarray(ref_multibit.multi_bit_blind_rotate(
        ref_key, jnp.asarray(lut), jnp.asarray(lwe)))
    got = core.multi_bit_blind_rotate(s.bsk, to_tensor(lut, "cpu"),
                                      to_tensor(lwe, "cpu"))
    assert np.array_equal(to_numpy(got), want)
    scan3 = core.prepare_multi_bit_bsk(s.raw_bsk, p.pbs_base_log,
                                       p.grouping_factor, "scan3")
    again = core.multi_bit_blind_rotate(scan3, to_tensor(lut, "cpu"),
                                        to_tensor(lwe, "cpu"), mode="scan3")
    assert torch.equal(again, got)


@pytest.mark.parametrize("order", ["ks_pbs", "pbs_ks"])
def test_shortint_lut_matches_reference_in_both_orders(order):
    rc, rs, c, s = _keys(order)
    assert np.array_equal(to_numpy(s.raw_bsk), np.asarray(rs.raw_bsk))
    f = lambda x: (3 * x + 5) % 16  # noqa: E731
    rb, b = rc.encrypt_batch(MSGS), c.encrypt_batch(MSGS)
    assert np.array_equal(to_numpy(b.data), rb.data)
    want = rs.apply_lookup_table_batch(rb, rs.generate_lookup_table(f))
    got = s.apply_lookup_table_batch(b, s.generate_lookup_table(f))
    assert np.array_equal(to_numpy(got.data), want.data)
    assert np.array_equal(c.decrypt_batch_message_and_carry(got),
                          [f(int(m)) for m in MSGS])


def test_lut_and_add_through_an_ntt_key_carried_across():
    rc, rs, c, _ = _keys("ks_pbs")
    s = weights.server_key_from_reference(
        PARAMS, np.asarray(rs.raw_bsk), np.asarray(rs.raw_ksk), device="cpu",
        mode="ntt")
    assert isinstance(s.bsk, core.PreparedMultiBitBskNtt)
    x, y = c.encrypt(3), c.encrypt(2)
    assert c.decrypt(s.add(x, y)) == 1  # (3 + 2) mod 4, carry cleaned
    out = s.apply_lookup_table_batch(c.encrypt_batch(MSGS),
                                     s.generate_lookup_table(lambda v: v // 4))
    assert np.array_equal(c.decrypt_batch_message_and_carry(out), MSGS // 4)
    assert s.mode == "ntt"


def test_layouts_refuse_each_others_modes():
    _, _, _, s = _keys("ks_pbs")
    lut = torch.zeros((PARAMS.glwe_size, PARAMS.polynomial_size),
                      dtype=torch.int64)
    lwe = torch.zeros((1, PARAMS.lwe_dimension + 1), dtype=torch.int64)
    with pytest.raises(ValueError, match="mode"):
        core.multi_bit_blind_rotate(s.bsk, lut, lwe, mode="scan3")
    cuda_layout = core.prepare_multi_bit_bsk_cuda(
        s.raw_bsk, PARAMS.pbs_base_log, PARAMS.grouping_factor)
    with pytest.raises(ValueError, match="mode"):
        core.multi_bit_blind_rotate(cuda_layout, lut, lwe, mode="ntt")
    with pytest.raises(ValueError, match="mode"):
        core.prepare_multi_bit_bsk(s.raw_bsk, PARAMS.pbs_base_log,
                                   PARAMS.grouping_factor, "scan2")
