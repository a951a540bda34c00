"""Port's keys and ciphertexts == tfhe_tpu's, byte for byte, from one seed
(PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST), and keys carried across from the
reference with tfhe_tpu_torch.weights."""

import numpy as np
import pytest

from tfhe_tpu import core as ref_core
from tfhe_tpu import shortint as ref_shortint
from tfhe_tpu.params import PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST as REF_PARAMS

from tfhe_tpu_torch import core, shortint
from tfhe_tpu_torch.ops.torus import to_numpy
from tfhe_tpu_torch.params import PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST as PARAMS
from tfhe_tpu_torch.weights import (client_key_from_reference,
                                    server_key_from_reference)

SEED = 1234


@pytest.fixture(scope="module")
def both():
    ref = ref_shortint.gen_keys(REF_PARAMS, seed=SEED)
    ours = shortint.gen_keys(PARAMS, seed=SEED, device="cpu")
    return ref, ours


def test_parameters_match_reference():
    import dataclasses

    from tfhe_tpu import params as ref_params
    from tfhe_tpu_torch import params

    for name, p in params.ALL_PARAMETER_SETS.items():
        ref = getattr(ref_params, name)
        for field in dataclasses.fields(p):
            a, b = getattr(p, field.name), getattr(ref, field.name)
            if field.name == "encryption_key_choice":
                a, b = a.value, b.value
            assert a == b, (name, field.name)
        assert (p.delta, p.ciphertext_lwe_size, p.max_noise_level) == (
            ref.delta, ref.ciphertext_lwe_size, ref.max_noise_level)


def test_secret_and_server_keys_byte_identical(both):
    (rc, rsk), (pc, psk) = both
    assert np.array_equal(to_numpy(pc.lwe_sk.bits_array), rc.lwe_sk.bits_array)
    assert np.array_equal(to_numpy(pc.glwe_sk.bits_array),
                          rc.glwe_sk.bits_array)
    assert psk.raw_bsk.shape == rsk.raw_bsk.shape
    assert np.array_equal(to_numpy(psk.raw_bsk), rsk.raw_bsk)
    assert np.array_equal(to_numpy(psk.raw_ksk), rsk.raw_ksk)


def test_ciphertexts_byte_identical(both):
    (rc, _), (pc, _) = both
    msgs = np.arange(16)
    rb, pb = rc.encrypt_batch(msgs), pc.encrypt_batch(msgs)
    assert np.array_equal(to_numpy(pb.data), rb.data)
    assert np.array_equal(pb.degrees, rb.degrees)
    assert np.array_equal(to_numpy(pc.encrypt(3).data), rc.encrypt(3).data)
    assert np.array_equal(pc.decrypt_batch_message_and_carry(pb), msgs)


def test_glwe_encryption_byte_identical(both):
    (rc, _), (pc, _) = both
    rng = np.random.default_rng(5)
    preset = rng.integers(0, 2**64 - 1, (3, PARAMS.polynomial_size),
                          dtype=np.uint64, endpoint=True)
    want = ref_core.encrypt_glwe_assign(rc.glwe_sk, preset, 1e-9, rc.enc_gen)
    got = core.encrypt_glwe_assign(pc.glwe_sk, preset, 1e-9, pc.enc_gen)
    assert np.array_equal(to_numpy(got), want)
    assert np.array_equal(to_numpy(core.decrypt_glwe(pc.glwe_sk, got)),
                          ref_core.decrypt_glwe(rc.glwe_sk, want))


@pytest.mark.parametrize("bits", [64, 32])
def test_trivial_lwe_and_lut_match_reference(bits):
    rng = np.random.default_rng(8)
    dt = np.uint64 if bits == 64 else np.uint32
    encoded = rng.integers(0, np.iinfo(dt).max, (3, 5), dtype=dt,
                           endpoint=True)
    got = core.trivial_lwe(encoded, 7, bits=bits, device="cpu")
    assert np.array_equal(to_numpy(got, bits),
                          ref_core.trivial_lwe(encoded, 7, bits=bits))
    f = lambda x: (3 * x + 1) % 16  # noqa: E731
    delta = 1 << (bits - 5)
    acc, degree = core.fill_accumulator(f, 256, 2, 16, delta, bits=bits,
                                        device="cpu")
    want, want_degree = ref_core.fill_accumulator(f, 256, 2, 16, delta,
                                                  bits=bits)
    assert np.array_equal(to_numpy(acc, bits), want)
    assert degree == want_degree


def test_server_key_from_reference_round_trips(both):
    (_, rsk), (_, psk) = both
    sks = server_key_from_reference(PARAMS, rsk.raw_bsk, rsk.raw_ksk,
                                    device="cpu")
    assert np.array_equal(to_numpy(sks.raw_bsk), rsk.raw_bsk)
    assert np.array_equal(to_numpy(sks.raw_ksk), rsk.raw_ksk)
    assert np.array_equal(sks.bsk.kspec.numpy(), psk.bsk.kspec.numpy())
    assert np.array_equal(sks.bsk.kshoup.numpy(), psk.bsk.kshoup.numpy())
    assert np.array_equal(sks.ksk.matrix.numpy(), psk.ksk.matrix.numpy())


def test_client_key_from_reference_encrypts_like_the_reference(both):
    (rc, _), _ = both
    lwe_bits, glwe_bits = rc.lwe_sk.bits_array, rc.glwe_sk.bits_array
    ref = ref_shortint.ClientKey.from_raw(REF_PARAMS, lwe_bits, glwe_bits,
                                          seed=77)
    ours = client_key_from_reference(PARAMS, lwe_bits, glwe_bits, seed=77,
                                     device="cpu")
    msgs = np.array([0, 5, 15, 9])
    rb, pb = ref.encrypt_batch(msgs), ours.encrypt_batch(msgs)
    assert np.array_equal(to_numpy(pb.data), rb.data)
    assert np.array_equal(ours.decrypt_batch_message_and_carry(pb), msgs)
