"""Shortint (both PBS orders) and boolean keys with mode="ntt", the
CRT-NTT key layout (tfhe_tpu_torch, on the CPU) == tfhe_tpu, which runs
that layout off the TPU, word for word, and == the port's scan2 on the same
raw keys; the reference's raw keys carried into the layout by
`weights.py`; and a multi-bit key's mode="ntt" equal to its scan3.  (The
layout's external product and blind rotation:
tests/test_torch_polymul_ntt.py.)"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from tfhe_tpu import boolean as ref_boolean
from tfhe_tpu import shortint as ref_shortint
from tfhe_tpu.params import BOOLEAN_TEST_PARAMETERS as REF_BOOLEAN
from tfhe_tpu.params import EncryptionKeyChoice as RefKeyChoice
from tfhe_tpu.params import PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST as REF_CLASSIC

from tfhe_tpu_torch import boolean, core, shortint, weights
from tfhe_tpu_torch.ops.torus import to_numpy, to_tensor
from tfhe_tpu_torch.params import (
    BOOLEAN_TEST_PARAMETERS, PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST,
    PARAM_MULTI_BIT_MESSAGE_2_CARRY_2_GROUP_2_TEST, EncryptionKeyChoice)

SEED = 57
VALUES = np.arange(16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run thousands of small tensor ops; one thread
    each keeps them fast when several test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _shortint_params(order):
    if order == "ks_pbs":
        return REF_CLASSIC, PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST
    small = EncryptionKeyChoice.SMALL
    return (dataclasses.replace(REF_CLASSIC,
                                encryption_key_choice=RefKeyChoice.SMALL),
            dataclasses.replace(PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST,
                                encryption_key_choice=small))


@functools.cache
def _shortint_keys(order):
    ref_p, p = _shortint_params(order)
    rc, rs = ref_shortint.gen_keys(ref_p, seed=SEED)
    c, s = shortint.gen_keys(p, seed=SEED, device="cpu", mode="ntt")
    return rc, rs, c, s


@pytest.mark.parametrize("order", ["ks_pbs", "pbs_ks"])
def test_shortint_ntt_key_matches_reference_and_scan2(order):
    rc, rs, c, s = _shortint_keys(order)
    assert s.mode == "ntt" and isinstance(s.bsk, core.PreparedBskNtt)
    assert np.array_equal(to_numpy(s.raw_bsk), rs.raw_bsk)
    f = lambda x: (5 * x + 3) % 16  # noqa: E731
    rb, b = rc.encrypt_batch(VALUES), c.encrypt_batch(VALUES)
    want = rs.apply_lookup_table_batch(rb, rs.generate_lookup_table(f))
    got = s.apply_lookup_table_batch(b, s.generate_lookup_table(f))
    assert np.array_equal(to_numpy(got.data), want.data)
    assert np.array_equal(c.decrypt_batch_message_and_carry(got),
                          [f(int(v)) for v in VALUES])
    scan2 = shortint.ServerKey.from_raw(s.params, s.raw_bsk, s.raw_ksk,
                                        device="cpu", mode="scan2")
    again = scan2.apply_lookup_table_batch(b, scan2.generate_lookup_table(f))
    assert torch.equal(again.data, got.data)
    # a bivariate op family through the one-block API
    x, y = c.encrypt(3), c.encrypt(2)
    assert c.decrypt(s.bitxor(x, y)) == 1 and c.decrypt(s.mul_lsb(x, y)) == 2


def test_ntt_mode_is_refused_on_a_multi_bit_key():
    """Since the multi-bit CRT-NTT layout was ported, a multi-bit key takes
    mode="ntt" (the name is kept from when it refused it): its ciphertexts
    equal the scan3 key's; an unknown mode still raises, on either key
    kind.  (The layout against the reference:
    tests/test_torch_multibit_ntt.py.)"""
    p = PARAM_MULTI_BIT_MESSAGE_2_CARRY_2_GROUP_2_TEST
    cks = shortint.ClientKey(p, seed=1, device="cpu")
    ntt_key = shortint.ServerKey(cks, mode="ntt")
    assert isinstance(ntt_key.bsk, core.PreparedMultiBitBskNtt)
    scan3 = shortint.ServerKey.from_raw(p, ntt_key.raw_bsk, ntt_key.raw_ksk,
                                        device="cpu", mode="scan3")
    f = lambda x: (7 * x + 2) % 16  # noqa: E731
    b = cks.encrypt_batch(VALUES)
    got = ntt_key.apply_lookup_table_batch(b, ntt_key.generate_lookup_table(f))
    want = scan3.apply_lookup_table_batch(b, scan3.generate_lookup_table(f))
    assert torch.equal(got.data, want.data)
    assert np.array_equal(cks.decrypt_batch_message_and_carry(got),
                          [f(int(v)) for v in VALUES])
    for params in (p, PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST):
        with pytest.raises(ValueError, match="mode"):
            shortint.gen_keys(params, seed=1, device="cpu", mode="ntt3")


@functools.cache
def _boolean_keys():
    rc, rs = ref_boolean.gen_keys(REF_BOOLEAN, seed=SEED)
    c, s = boolean.gen_keys(BOOLEAN_TEST_PARAMETERS, seed=SEED, device="cpu",
                            mode="ntt")
    return rc, rs, c, s


def test_boolean_ntt_key_matches_reference_and_scan2():
    rc, rs, c, s = _boolean_keys()
    assert s.mode == "ntt" and s.bsk.bits == 32
    x = np.array([False, False, True, True])
    y = np.array([False, True, False, True])
    z = np.array([True, False, True, False])
    ra, rb, rz = (rc.encrypt_batch(v) for v in (x, y, z))
    a, b, cz = (c.encrypt_batch(v) for v in (x, y, z))
    scan2 = boolean.ServerKey.from_raw(BOOLEAN_TEST_PARAMETERS, s.raw_bsk,
                                       s.raw_ksk, device="cpu", mode="scan2")
    for gate, want in (("nand", ~(x & y)), ("xor", x ^ y), ("or", x | y)):
        got = getattr(s, f"{gate}_batch")(a, b)
        assert np.array_equal(to_numpy(got, 32),
                              np.asarray(getattr(rs, f"{gate}_batch")(ra, rb)))
        assert torch.equal(got, getattr(scan2, f"{gate}_batch")(a, b))
        assert np.array_equal(c.decrypt_batch(got), want)
    got = s.mux_batch(cz, a, b)
    assert np.array_equal(to_numpy(got, 32),
                          np.asarray(rs.mux_batch(rz, ra, rb)))
    assert torch.equal(got, scan2.mux_batch(cz, a, b))
    assert np.array_equal(c.decrypt_batch(got), np.where(z, x, y))


def test_weights_carry_keys_across_into_the_ntt_layout():
    rc, rs, c, _ = _shortint_keys("ks_pbs")
    s = weights.server_key_from_reference(
        PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST, rs.raw_bsk, rs.raw_ksk,
        device="cpu", mode="ntt")
    assert isinstance(s.bsk, core.PreparedBskNtt)
    rb = rc.encrypt_batch(VALUES)
    f = lambda x: (x + 7) % 16  # noqa: E731
    want = rs.apply_lookup_table_batch(rb, rs.generate_lookup_table(f))
    got = s.apply_lookup_table_batch(
        shortint.ShortintBatch(data=to_tensor(rb.data, "cpu"),
                               degrees=rb.degrees,
                               message_modulus=rb.message_modulus,
                               carry_modulus=rb.carry_modulus),
        s.generate_lookup_table(f))
    assert np.array_equal(to_numpy(got.data), want.data)
    _, _, _, bs = _boolean_keys()
    b = weights.boolean_server_key_from_reference(
        BOOLEAN_TEST_PARAMETERS, to_numpy(bs.raw_bsk, 32),
        to_numpy(bs.raw_ksk, 32), device="cpu", mode="ntt")
    assert b.mode == "ntt" and torch.equal(b.bsk.spectra, bs.bsk.spectra)
