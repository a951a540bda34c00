"""Public-key encryption in both packages from one seed
(PARAM_MESSAGE_2_CARRY_2_TEST, seed 2024; every case of
tests/test_public_key.py but the API's): the polynomial helpers, the
standard, compact (one and two bins), compressed and compressed compact
keys and their ciphertexts, equal word for word (tolerance 0) before the
port's are decrypted; and the boolean PublicKey at
BOOLEAN_SHA_TEST_PARAMETERS, seed 10."""

import numpy as np
import pytest
import torch

from tfhe_tpu import boolean as ref_boolean
from tfhe_tpu import shortint as ref_shortint
from tfhe_tpu.core import public_key as ref_pk
from tfhe_tpu.params import BOOLEAN_SHA_TEST_PARAMETERS as REF_BOOL
from tfhe_tpu.params import PARAM_MESSAGE_2_CARRY_2_TEST as REF_P
from tfhe_tpu.utils import serialization as ref_ser

from tfhe_tpu_torch import boolean, shortint
from tfhe_tpu_torch.core import public_key as core_pk
from tfhe_tpu_torch.params import BOOLEAN_SHA_TEST_PARAMETERS as BOOL_P
from tfhe_tpu_torch.params import PARAM_MESSAGE_2_CARRY_2_TEST as P
from tfhe_tpu_torch.utils import safe_deserialize, safe_serialize

from torch_wopbs_pair import (  # noqa: F401
    assert_batches_equal, one_torch_thread, words)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.uint64).view(np.int64).copy())


@pytest.fixture(scope="module")
def keys():
    return (ref_shortint.gen_keys(REF_P, seed=2024),
            shortint.gen_keys(P, seed=2024, device="cpu"))


def test_negacyclic_mul_matches_naive_and_reference():
    rng = np.random.default_rng(0)
    n = 16
    a = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    b = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    got = words(core_pk.negacyclic_mul(_t(a), _t(b)))
    want = [0] * n
    for i in range(n):
        for j in range(n):
            sign = -1 if i + j >= n else 1
            want[(i + j) % n] = (want[(i + j) % n]
                                 + sign * int(a[i]) * int(b[j])) % (1 << 64)
    np.testing.assert_array_equal(got, np.array(want, dtype=np.uint64))
    np.testing.assert_array_equal(got, ref_pk.negacyclic_mul(a, b))
    np.testing.assert_array_equal(
        words(core_pk.semi_reverse_negacyclic_conv(_t(a), _t(b))),
        ref_pk.semi_reverse_negacyclic_conv(a, b))


def test_monic_monomial_mul():
    p = np.array([1, 2, 3, 4], dtype=np.uint64)
    np.testing.assert_array_equal(
        words(core_pk.monic_monomial_mul(_t(p), 1)),
        np.array([(1 << 64) - 4, 1, 2, 3], dtype=np.uint64))
    for d in (4, 8, 5, 11):
        np.testing.assert_array_equal(
            words(core_pk.monic_monomial_mul(_t(p), d)),
            ref_pk.monic_monomial_mul(p, d))


def test_standard_public_key(keys):
    (rc, rs), (c, s) = keys
    rpk, pk = ref_shortint.PublicKey(rc), shortint.PublicKey(c)
    assert pk.key.zero_encryption_count == (P.big_lwe_dimension + 1) * 64 + 128
    np.testing.assert_array_equal(words(pk.key.zero_encs),
                                  words(rpk.key.zero_encs))
    msgs = np.array([0, 1, 2, 3], dtype=np.uint64)
    rb, b = rpk.encrypt_batch(msgs, seed=5), pk.encrypt_batch(msgs, seed=5)
    assert_batches_equal(rb, b)
    np.testing.assert_array_equal(c.decrypt_batch(b), msgs)
    # public-key ciphertexts are ordinary ciphertexts: PBS works on them
    out = s.apply_lookup_table_batch(b, s.generate_lookup_table(
        lambda x: (x + 1) % 4))
    ref_out = rs.apply_lookup_table_batch(rb, rs.generate_lookup_table(
        lambda x: (x + 1) % 4))
    assert_batches_equal(ref_out, out)
    np.testing.assert_array_equal(c.decrypt_batch(out), (msgs + 1) % 4)


@pytest.mark.parametrize("extra", [0, 3])
def test_compact_public_key(keys, extra):
    """extra = 3: n + 3 messages, two bins."""
    (rc, _), (c, _) = keys
    rcpk, cpk = ref_shortint.CompactPublicKey(rc), shortint.CompactPublicKey(c)
    np.testing.assert_array_equal(words(cpk.key.mask), words(rcpk.key.mask))
    np.testing.assert_array_equal(words(cpk.key.body), words(rcpk.key.body))
    n = cpk.key.lwe_dimension
    msgs = (np.arange(n + 3, dtype=np.uint64) % 4 if extra
            else np.array([3, 2, 1, 0, 1, 2], dtype=np.uint64))
    rl = rcpk.encrypt_compact_batch(msgs, seed=6 + extra)
    cl = cpk.encrypt_compact_batch(msgs, seed=6 + extra)
    assert cl.compact.masks.shape == (-(-len(msgs) // n), n)
    np.testing.assert_array_equal(words(cl.compact.masks),
                                  words(rl.compact.masks))
    np.testing.assert_array_equal(words(cl.compact.bodies),
                                  words(rl.compact.bodies))
    batch = cl.expand()
    assert_batches_equal(rl.expand(), batch)
    np.testing.assert_array_equal(c.decrypt_batch(batch), msgs)


def test_public_key_serialization(keys):
    (rc, _), (c, _) = keys
    msgs = np.array([2, 3], dtype=np.uint64)
    for ref_cls, cls, seed in ((ref_shortint.PublicKey, shortint.PublicKey,
                                8),
                               (ref_shortint.CompactPublicKey,
                                shortint.CompactPublicKey, 9)):
        data = safe_serialize(cls(c))
        assert data == ref_ser.safe_serialize(ref_cls(rc))
        back = safe_deserialize(data, device="cpu")
        np.testing.assert_array_equal(
            c.decrypt_batch(back.encrypt_batch(msgs, seed=seed)), msgs)


def test_compressed_public_key(keys):
    (rc, _), (c, _) = keys
    rcomp, comp = ref_shortint.CompressedPublicKey(rc), \
        shortint.CompressedPublicKey(c)
    assert comp.seeded.mask_seed == rcomp.seeded.mask_seed
    np.testing.assert_array_equal(words(comp.seeded.bodies),
                                  words(rcomp.seeded.bodies))
    back = safe_deserialize(safe_serialize(comp), device="cpu")
    pk = back.decompress()
    np.testing.assert_array_equal(
        words(pk.key.zero_encs), words(rcomp.decompress().key.zero_encs))
    msgs = np.array([1, 3], dtype=np.uint64)
    np.testing.assert_array_equal(
        c.decrypt_batch(pk.encrypt_batch(msgs, seed=12)), msgs)
    assert len(safe_serialize(comp)) < len(safe_serialize(pk)) // 4


def test_compressed_compact_public_key(keys):
    (rc, _), (c, _) = keys
    rcomp = ref_shortint.CompressedCompactPublicKey(rc)
    comp = shortint.CompressedCompactPublicKey(c)
    np.testing.assert_array_equal(words(comp.seeded.body),
                                  words(rcomp.seeded.body))
    cpk = safe_deserialize(safe_serialize(comp), device="cpu").decompress()
    np.testing.assert_array_equal(words(cpk.key.mask),
                                  words(rcomp.decompress().key.mask))
    msgs = np.array([2, 0, 3], dtype=np.uint64)
    np.testing.assert_array_equal(
        c.decrypt_batch(cpk.encrypt_batch(msgs, seed=13)), msgs)


def test_boolean_public_key():
    rc, rs = ref_boolean.gen_keys(REF_BOOL, seed=10)
    c, s = boolean.gen_keys(BOOL_P, seed=10, device="cpu")
    rpk, pk = ref_boolean.PublicKey(rc), boolean.PublicKey(c)
    np.testing.assert_array_equal(
        pk.key.zero_encs.numpy(), np.asarray(rpk.key.zero_encs, np.int64))
    bits = np.array([True, False, True, True])
    ct = pk.encrypt_batch(bits, seed=3)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(
        rpk.encrypt_batch(bits, seed=3), np.int64))
    np.testing.assert_array_equal(c.decrypt_batch(ct), bits)
    # gates work on public-key ciphertexts
    np.testing.assert_array_equal(c.decrypt_batch(s.and_batch(ct, ct)), bits)
