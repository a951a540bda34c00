"""The wire format in both packages from the same seeds (every shortint
and CRT case of tests/test_serialization.py and tests/test_crt.py::
test_crt_serialization): for each object the port writes the reference's
bytes, each package loads the other's, and what loads works; the size
limit, the bad magic, the conformance error, and the seeded ciphertexts
and keys bit-exact."""

import numpy as np
import pytest

from tfhe_tpu import integer as ref_integer
from tfhe_tpu import shortint as ref_shortint
from tfhe_tpu.core import seeded as ref_seeded
from tfhe_tpu.params import PARAM_MESSAGE_2_CARRY_2_TEST as REF_P

from tfhe_tpu_torch import integer, shortint
from tfhe_tpu_torch.core import seeded
from tfhe_tpu_torch.params import (PARAM_MESSAGE_2_CARRY_2_KS_PBS,
                                   PARAM_MESSAGE_2_CARRY_2_TEST as P)
from tfhe_tpu_torch.utils import (ConformanceError, DeserializationError,
                                  safe_deserialize, safe_serialize)

from torch_wire_pair import cross
from torch_wopbs_pair import (  # noqa: F401
    assert_batches_equal, one_torch_thread, words)


@pytest.fixture(scope="module")
def keys():
    return (ref_shortint.gen_keys(REF_P, seed=1234),
            shortint.gen_keys(P, seed=1234, device="cpu"))


def test_params_round_trip():
    back, ref_back = cross(REF_P, P)
    assert back == P
    assert ref_back == REF_P


def test_batch_round_trip(keys):
    (rc, _), (c, _) = keys
    msgs = np.array([0, 1, 2, 3], dtype=np.uint64)
    back, ref_back = cross(rc.encrypt_batch(msgs), c.encrypt_batch(msgs))
    np.testing.assert_array_equal(c.decrypt_batch(back), msgs)
    np.testing.assert_array_equal(rc.decrypt_batch(ref_back), msgs)
    assert_batches_equal(ref_back, back)


def test_client_key_round_trip(keys):
    (rc, _), (c, _) = keys
    back, ref_back = cross(rc, c)
    np.testing.assert_array_equal(words(back.lwe_sk.bits_array),
                                  words(c.lwe_sk.bits_array))
    np.testing.assert_array_equal(words(back.glwe_sk.bits_array),
                                  words(c.glwe_sk.bits_array))
    assert back.decrypt_batch(c.encrypt_batch([3]))[0] == 3
    assert ref_back.decrypt_batch(rc.encrypt_batch([3]))[0] == 3


def test_server_key_round_trip(keys):
    (rc, rs), (c, s) = keys
    back, ref_back = cross(rs, s)
    np.testing.assert_array_equal(words(back.raw_bsk), words(s.raw_bsk))
    np.testing.assert_array_equal(words(back.raw_ksk), words(s.raw_ksk))
    lut = back.generate_lookup_table(lambda x: (x + 1) % 4)
    ct = c.encrypt_batch([0, 1, 2, 3])
    rc.encrypt_batch([0, 1, 2, 3])  # keeps the two generators in step
    out = back.apply_lookup_table_batch(ct, lut)
    np.testing.assert_array_equal(
        words(out.data), words(s.apply_lookup_table_batch(ct, lut).data))
    np.testing.assert_array_equal(c.decrypt_batch(out), [1, 2, 3, 0])


@pytest.mark.parametrize("signed", [False, True])
def test_radix_round_trip(signed):
    rck = ref_integer.RadixClientKey(REF_P, num_blocks=4, seed=77)
    ck = integer.RadixClientKey(P, num_blocks=4, seed=77, device="cpu")
    if signed:
        back, ref_back = cross(rck.encrypt_signed(-55), ck.encrypt_signed(-55))
        assert type(back).__name__ == "SignedRadixCiphertext"
        assert ck.decrypt_signed(back) == -55
        assert rck.decrypt_signed(ref_back) == -55
    else:
        back, ref_back = cross(rck.encrypt(123), ck.encrypt(123))
        assert type(back).__name__ == "RadixCiphertext"
        assert ck.decrypt(back) == 123
        assert rck.decrypt(ref_back) == 123


def test_crt_serialization():
    from tfhe_tpu.integer.crt import CrtClientKey as RefCrt

    rck = RefCrt(REF_P, [2, 3], seed=999)
    ck = integer.CrtClientKey(P, [2, 3], seed=999, device="cpu")
    back, ref_back = cross(rck.encrypt(5), ck.encrypt(5))
    assert back.moduli == [2, 3]
    assert ck.decrypt(back) == 5
    assert rck.decrypt(ref_back) == 5


def test_compressed_ciphertext_list(keys):
    (rc, _), (c, _) = keys
    msgs = np.array([3, 1, 0, 2], dtype=np.uint64)
    comp = shortint.encrypt_compressed_batch(c, msgs)
    assert comp.seeded.bodies.shape == (4,)
    back, ref_back = cross(ref_shortint.encrypt_compressed_batch(rc, msgs),
                           comp)
    batch = back.decompress()
    assert_batches_equal(ref_back.decompress(), batch)
    np.testing.assert_array_equal(c.decrypt_batch(batch), msgs)


def test_seeded_lwe_bitexact(keys):
    """Decompression regenerates the exact mask of the encryption."""
    (rc, _), (c, _) = keys
    enc = np.array([5, 6], dtype=np.uint64) * np.uint64(P.delta)
    r_sk, std = rc.encryption_key_and_noise
    sk, _ = c.encryption_key_and_noise
    r_seeded = ref_seeded.encrypt_seeded_lwe(r_sk, enc, std, 0xDEADBEEF,
                                             rc.enc_gen)
    s = seeded.encrypt_seeded_lwe(sk, enc, std, 0xDEADBEEF, c.enc_gen)
    np.testing.assert_array_equal(words(s.bodies), words(r_seeded.bodies))
    full = seeded.decompress_seeded_lwe(s)
    np.testing.assert_array_equal(
        words(full), words(ref_seeded.decompress_seeded_lwe(r_seeded)))
    np.testing.assert_array_equal(c.decrypt_batch_message_and_carry(full),
                                  [5, 6])


def test_compressed_server_key(keys):
    (rc, rs), (c, s) = keys
    rcomp, comp = ref_shortint.CompressedServerKey(rc), \
        shortint.CompressedServerKey(c)
    back, ref_back = cross(rcomp, comp)
    sks2 = back.decompress()
    ref_sks2 = ref_back.decompress()
    np.testing.assert_array_equal(words(sks2.raw_bsk),
                                  words(ref_sks2.raw_bsk))
    np.testing.assert_array_equal(words(sks2.raw_ksk),
                                  words(ref_sks2.raw_ksk))
    lut = sks2.generate_lookup_table(lambda x: (3 * x) % 4)
    rc.encrypt_batch([0, 1, 2, 3])  # keeps the two generators in step
    out = sks2.apply_lookup_table_batch(c.encrypt_batch([0, 1, 2, 3]), lut)
    np.testing.assert_array_equal(c.decrypt_batch(out), [0, 3, 2, 1])


def test_compressed_server_key_bitexact_masks(keys):
    """compress(decompress(x)) gives back the seeded form."""
    (rc, _), (c, _) = keys
    comp = shortint.CompressedServerKey(c)
    bsk = seeded.decompress_bootstrap_key(comp.seeded_bsk)
    re = seeded.compress_bootstrap_key(bsk, comp.seeded_bsk.mask_seed,
                                       comp.seeded_bsk.base_log)
    np.testing.assert_array_equal(words(re.bodies),
                                  words(comp.seeded_bsk.bodies))
    np.testing.assert_array_equal(words(seeded.decompress_bootstrap_key(re)),
                                  words(bsk))
    ksk = seeded.decompress_keyswitch_key(comp.seeded_ksk)
    rk = seeded.compress_keyswitch_key(ksk, comp.seeded_ksk.mask_seed,
                                       comp.seeded_ksk.base_log)
    np.testing.assert_array_equal(words(seeded.decompress_keyswitch_key(rk)),
                                  words(ksk))


def test_conformance_error(keys):
    (_, _), (c, _) = keys
    data = safe_serialize(c)
    with pytest.raises(ConformanceError):
        safe_deserialize(data, expected_params=PARAM_MESSAGE_2_CARRY_2_KS_PBS,
                         device="cpu")
    safe_deserialize(data, expected_params=P, device="cpu")
    batch = safe_serialize(c.encrypt_batch([1]))
    with pytest.raises(ConformanceError):
        safe_deserialize(batch, expected_params=PARAM_MESSAGE_2_CARRY_2_KS_PBS,
                         device="cpu")


def test_size_limit(keys):
    (_, _), (c, _) = keys
    data = safe_serialize(c)
    with pytest.raises(DeserializationError):
        safe_deserialize(data, limit=64, device="cpu")
    with pytest.raises(DeserializationError):
        safe_serialize(c, limit=64)


def test_bad_magic():
    with pytest.raises(DeserializationError):
        safe_deserialize(b"NOTMAGIC" + b"\x00" * 32, device="cpu")
