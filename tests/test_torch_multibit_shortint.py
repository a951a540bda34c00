"""The multi-bit slice as a whole on the CPU, at
PARAM_MULTI_BIT_MESSAGE_2_CARRY_2_GROUP_2_TEST: keys carried across from
tfhe_tpu.shortint.gen_keys with tfhe_tpu_torch.weights give LUT outputs
bit-identical to the reference's, in both schedules, and they decrypt to the
clear function; the port's own gen_keys gives the reference's keys from the
same seed."""

import numpy as np
import pytest
import torch

from tfhe_tpu import shortint as ref_shortint
from tfhe_tpu.params import (
    PARAM_MULTI_BIT_MESSAGE_2_CARRY_2_GROUP_2_TEST as REF_PARAMS)

from tfhe_tpu_torch import core, shortint
from tfhe_tpu_torch.ops import fused_multibit
from tfhe_tpu_torch.ops.torus import to_numpy, to_tensor
from tfhe_tpu_torch.params import (
    PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST,
    PARAM_MULTI_BIT_MESSAGE_2_CARRY_2_GROUP_2_TEST as PARAMS)
from tfhe_tpu_torch.weights import (client_key_from_reference,
                                    server_key_from_reference)

SEED = 77
MSGS = np.arange(16)


@pytest.fixture(scope="module")
def keys():
    rc, rsk = ref_shortint.gen_keys(REF_PARAMS, seed=SEED)
    psk = server_key_from_reference(PARAMS, np.asarray(rsk.raw_bsk),
                                    np.asarray(rsk.raw_ksk), device="cpu")
    pc = client_key_from_reference(PARAMS, rc.lwe_sk.bits_array,
                                   rc.glwe_sk.bits_array, seed=1,
                                   device="cpu")
    assert psk.is_multi_bit
    return rc, rsk, pc, psk


def _ours(batch):
    return shortint.ShortintBatch(
        data=to_tensor(batch.data, "cpu"), degrees=batch.degrees.copy(),
        message_modulus=batch.message_modulus,
        carry_modulus=batch.carry_modulus)


def test_gen_keys_from_a_seed_match_reference(keys):
    _, rsk, _, _ = keys
    pc, psk = shortint.gen_keys(PARAMS, seed=SEED, device="cpu")
    assert isinstance(psk.bsk, core.PreparedMultiBitBskCuda)
    assert tuple(psk.raw_bsk.shape) == (8, 4, 1, 2, 2, 256)
    assert np.array_equal(to_numpy(psk.raw_bsk), np.asarray(rsk.raw_bsk))
    assert np.array_equal(to_numpy(psk.raw_ksk), np.asarray(rsk.raw_ksk))


def test_univariate_lut_matches_reference(keys):
    rc, rsk, pc, psk = keys
    rb = rc.encrypt_batch(MSGS)
    f = lambda x: (3 * x + 5) % 16  # noqa: E731
    want = rsk.apply_lookup_table_batch(rb, rsk.generate_lookup_table(f))
    got = psk.apply_lookup_table_batch(_ours(rb),
                                       psk.generate_lookup_table(f))
    assert np.array_equal(to_numpy(got.data), want.data)
    assert np.array_equal(got.degrees, want.degrees)
    assert np.array_equal(pc.decrypt_batch_message_and_carry(got),
                          [f(int(m)) for m in MSGS])


def test_bivariate_lut_matches_reference(keys):
    rc, rsk, pc, psk = keys
    lhs, rhs = MSGS % 4, MSGS // 4
    ra, rb = rc.encrypt_batch(lhs), rc.encrypt_batch(rhs)
    f = lambda a, b: (a * b + 1) % 4  # noqa: E731
    want = rsk.unchecked_bivariate_batch(
        ra, rb, rsk.generate_lookup_table_bivariate(f))
    got = psk.unchecked_bivariate_batch(
        _ours(ra), _ours(rb), psk.generate_lookup_table_bivariate(f))
    assert np.array_equal(to_numpy(got.data), want.data)
    assert np.array_equal(pc.decrypt_batch(got), (lhs * rhs + 1) % 4)


def test_both_schedules_give_the_server_keys_output(keys):
    rc, _, pc, psk = keys
    data = to_tensor(rc.encrypt_batch(MSGS).data, "cpu")
    lut = psk.generate_lookup_table(lambda x: x // 4)
    want = psk._pbs_device(data, lut.acc)
    for mode in fused_multibit.MODES:
        got = core.keyswitch_then_multi_bit_pbs(psk.ksk, psk.bsk, lut.acc,
                                                data, mode=mode)
        assert torch.equal(got, want)
    assert np.array_equal(pc.decrypt_batch_message_and_carry(want), MSGS // 4)


def test_weights_reject_a_bsk_of_the_other_kind(keys):
    _, rsk, _, _ = keys
    with pytest.raises(ValueError, match="expected"):
        server_key_from_reference(PARAMS, np.zeros((16, 1, 2, 2, 256),
                                                   np.uint64),
                                  np.asarray(rsk.raw_ksk), device="cpu")
    with pytest.raises(ValueError, match="expected"):
        server_key_from_reference(PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST,
                                  np.asarray(rsk.raw_bsk),
                                  np.asarray(rsk.raw_ksk), device="cpu")
