"""The high-level API's second half in both packages from the same seeds
(PARAM_MESSAGE_2_CARRY_2_TEST): the API cases of tests/test_serialization.py
(FheUint8, FheInt8, FheBool, the compressed types, the compressed server
key, both keys, an FheString) and of tests/test_public_key.py:108-150
(PublicKey, CompactFheUint8, CompactFheInt8).  The port writes the
reference's bytes, each package loads the other's, and each result equals
the reference's words (tolerance 0) before it is decrypted."""

import numpy as np
import pytest

from tfhe_tpu import api as ref_api
from tfhe_tpu import strings as ref_strings
from tfhe_tpu.params import PARAM_MESSAGE_2_CARRY_2_TEST as REF_P

from tfhe_tpu_torch import api, strings
from tfhe_tpu_torch.params import PARAM_MESSAGE_2_CARRY_2_TEST as P
from tfhe_tpu_torch.utils import safe_deserialize, safe_serialize

from torch_wire_pair import cross
from torch_wopbs_pair import one_torch_thread, words  # noqa: F401


@pytest.fixture(scope="module")
def hl_keys():
    rk, rs = ref_api.generate_keys(
        ref_api.ConfigBuilder.default().use_custom_parameters(REF_P).build(),
        seed=4242)
    k, s = api.generate_keys(
        api.ConfigBuilder.default().use_custom_parameters(P).build(),
        seed=4242, device="cpu")
    return (rk, rs), (k, s)


@pytest.fixture
def server(hl_keys):
    (_, rs), (_, s) = hl_keys
    ref_api.set_server_key(rs)
    api.set_server_key(s)


def _blocks(x):
    return words(x.inner.blocks.data if hasattr(x.inner, "blocks")
                 else x.inner.block.data)


@pytest.mark.parametrize("cls,value", [("FheUint8", 200), ("FheInt8", -42),
                                       ("FheBool", True)])
def test_hl_round_trip(hl_keys, cls, value):
    (rk, _), (k, _) = hl_keys
    back, ref_back = cross(getattr(ref_api, cls).encrypt(value, rk),
                           getattr(api, cls).encrypt(value, k))
    assert type(back) is getattr(api, cls)
    assert type(ref_back) is getattr(ref_api, cls)
    assert back.decrypt(k) == value
    assert ref_back.decrypt(rk) == value


@pytest.mark.parametrize("cls,value", [("CompressedFheUint8", 123),
                                       ("CompressedFheInt8", -100)])
def test_hl_compressed(hl_keys, cls, value):
    (rk, _), (k, _) = hl_keys
    back, ref_back = cross(getattr(ref_api, cls).encrypt(value, rk),
                           getattr(api, cls).encrypt(value, k))
    val = back.decompress()
    assert type(val) is getattr(api, cls[len("Compressed"):])
    np.testing.assert_array_equal(_blocks(val), _blocks(ref_back.decompress()))
    assert val.decrypt(k) == value
    assert len(safe_serialize(back)) < len(safe_serialize(val)) // 2


def test_hl_compressed_server_key(hl_keys, server):
    (rk, rs), (k, s) = hl_keys
    back, ref_back = cross(ref_api.CompressedServerKey(rk),
                           api.CompressedServerKey(k))
    sks2 = back.decompress()
    api.set_server_key(sks2)
    try:
        a, b = api.FheUint8.encrypt(17, k), api.FheUint8.encrypt(5, k)
        # the reference's key encrypts alike, so the two stay in step
        ref_api.FheUint8.encrypt(17, rk), ref_api.FheUint8.encrypt(5, rk)
        assert (a + b).decrypt(k) == 22
    finally:
        api.set_server_key(s)


def test_hl_keys_round_trip(hl_keys):
    (rk, rs), (k, s) = hl_keys
    k2, _ = cross(rk, k)
    s2, _ = cross(rs, s)
    api.set_server_key(s2)
    try:
        a = api.FheUint8.encrypt(9, k2)
        assert (a * 3).decrypt(k2) == 27
        assert (a * 3).decrypt(k) == 27
    finally:
        api.set_server_key(s)


def test_hl_public_key(hl_keys, server):
    (rk, _), (k, _) = hl_keys
    rpk, pk = ref_api.PublicKey(rk), api.PublicKey(k)
    np.testing.assert_array_equal(words(pk.inner.key.zero_encs),
                                  words(rpk.inner.key.zero_encs))
    a = api.FheUint8.encrypt_with_public_key(77, pk)
    assert type(a) is api.FheUint8 and a.decrypt(k) == 77
    assert (a + api.FheUint8.encrypt(3, k)).decrypt(k) == 80
    ref_api.FheUint8.encrypt(3, rk)  # the two keys stay in step
    cross(rpk, pk)


@pytest.mark.parametrize("cls,value", [("CompactFheUint8", 123),
                                       ("CompactFheInt8", -77)])
def test_hl_compact(hl_keys, server, cls, value):
    (rk, _), (k, _) = hl_keys
    rcpk, cpk = ref_api.CompactPublicKey(rk), api.CompactPublicKey(k)
    np.testing.assert_array_equal(words(cpk.inner.key.body),
                                  words(rcpk.inner.key.body))
    compact = getattr(api, cls).encrypt(value, cpk)
    wire = safe_serialize(compact)
    val = safe_deserialize(wire, device="cpu").expand()
    assert type(val) is getattr(api, cls[len("Compact"):])
    assert val.decrypt(k) == value
    assert len(wire) < len(safe_serialize(val))
    if value < 0:
        assert (val + 7).decrypt(k) == value + 7
    # the reference loads the port's compact list and expands it alike
    from tfhe_tpu.utils import serialization as ref_ser

    ref_val = ref_ser.safe_deserialize(wire).expand()
    np.testing.assert_array_equal(_blocks(val), _blocks(ref_val))


def test_fhestring_round_trip():
    rc, _ = ref_strings.gen_keys_test(seed=888)
    c, s = strings.gen_keys_test(seed=888, device="cpu")
    back, ref_back = cross(rc.encrypt_str_random_padding("Wire!", 2),
                           c.encrypt_str_random_padding("Wire!", 2))
    assert back.padding == ref_back.padding
    assert c.decrypt_string(back) == "Wire!"
    assert rc.decrypt_string(ref_back) == "Wire!"
    assert c.decrypt_string(s.to_uppercase(back)) == "WIRE!"
    b2, _ = cross(rc.encrypt_str("ab"), c.encrypt_str("ab"))
    assert b2.length == 2 and c.decrypt_string(b2) == "ab"
