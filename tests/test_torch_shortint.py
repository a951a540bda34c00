"""The slice as a whole on the CPU: the port's keyswitch, keyswitch_then_pbs
and shortint LUT application give ciphertexts bit-identical to tfhe_tpu's
(PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST), and their decryptions equal the
clear function for every message."""

import numpy as np
import pytest

import jax
from tfhe_tpu import core as ref_core
from tfhe_tpu import shortint as ref_shortint
from tfhe_tpu.params import PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST as REF_PARAMS

from tfhe_tpu_torch import core, shortint
from tfhe_tpu_torch.ops.torus import to_numpy, to_tensor
from tfhe_tpu_torch.params import PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST as PARAMS

SEED = 99
MSGS = np.arange(16)


@pytest.fixture(scope="module")
def keys():
    rc, rsk = ref_shortint.gen_keys(REF_PARAMS, seed=SEED)
    pc, psk = shortint.gen_keys(PARAMS, seed=SEED, device="cpu")
    rb, pb = rc.encrypt_batch(MSGS), pc.encrypt_batch(MSGS)
    assert np.array_equal(to_numpy(pb.data), rb.data)
    return rc, rsk, pc, psk, rb, pb


def test_keyswitch_matches_reference(keys):
    _, rsk, _, psk, rb, pb = keys
    want = np.asarray(ref_core.keyswitch(rsk.ksk, rb.data))
    got = core.keyswitch(psk.ksk, pb.data)
    assert got.shape == (16, PARAMS.lwe_dimension + 1)
    assert np.array_equal(to_numpy(got), want)


def test_keyswitch_then_pbs_matches_reference(keys):
    _, rsk, pc, psk, rb, pb = keys
    lut = (7 * MSGS + 3) % 16
    ref_acc, _ = ref_core.make_lut_glwe(list(lut), PARAMS.polynomial_size,
                                        PARAMS.glwe_size, 16, PARAMS.delta)
    acc, _ = core.make_lut_glwe(list(lut), PARAMS.polynomial_size,
                                PARAMS.glwe_size, 16, PARAMS.delta,
                                device="cpu")
    assert np.array_equal(to_numpy(acc), ref_acc)
    want = np.asarray(jax.jit(ref_core.keyswitch_then_pbs)(
        rsk.ksk, rsk.bsk, ref_acc, rb.data))
    got = core.keyswitch_then_pbs(psk.ksk, psk.bsk, acc, pb.data)
    assert np.array_equal(to_numpy(got), want)
    assert np.array_equal(pc.decrypt_batch_message_and_carry(got), lut)


def test_univariate_lut_matches_reference(keys):
    rc, rsk, pc, psk, rb, pb = keys
    f = lambda x: (x * x + 1) % 16  # noqa: E731
    want = rsk.apply_lookup_table_batch(rb, rsk.generate_lookup_table(f))
    got = psk.apply_lookup_table_batch(pb, psk.generate_lookup_table(f))
    assert np.array_equal(to_numpy(got.data), want.data)
    assert np.array_equal(got.degrees, want.degrees)
    assert np.array_equal(pc.decrypt_batch_message_and_carry(got),
                          [f(int(m)) for m in MSGS])


def test_bivariate_lut_matches_reference(keys):
    rc, rsk, pc, psk, _, _ = keys
    lhs, rhs = MSGS % 4, MSGS // 4
    ra, rb_ = rc.encrypt_batch(lhs), rc.encrypt_batch(rhs)
    pa, pb_ = pc.encrypt_batch(lhs), pc.encrypt_batch(rhs)
    f = lambda a, b: (a + b) % 4  # noqa: E731
    want = rsk.unchecked_bivariate_batch(
        ra, rb_, rsk.generate_lookup_table_bivariate(f))
    got = psk.unchecked_bivariate_batch(
        pa, pb_, psk.generate_lookup_table_bivariate(f))
    assert np.array_equal(to_numpy(got.data), want.data)
    assert np.array_equal(pc.decrypt_batch(got), (lhs + rhs) % 4)


def test_one_block_api_matches_batch(keys):
    rc, _, pc, psk, _, _ = keys
    ct, want = pc.encrypt(6), rc.encrypt(6)
    assert np.array_equal(to_numpy(ct.data), want.data)
    assert ct.degree == want.degree
    assert pc.decrypt_message_and_carry(ct) == 6 and pc.decrypt(ct) == 2
    empty = psk.apply_lookup_table_batch(pc.encrypt_batch(np.arange(0)),
                                         psk.generate_lookup_table(lambda x: x))
    assert tuple(empty.data.shape) == (0, PARAMS.ciphertext_lwe_size)
    with pytest.raises(ValueError):
        psk._pbs_device(to_tensor(np.zeros((1, 257), np.uint64), "meta"),
                        psk.generate_lookup_table(lambda x: x).acc)
