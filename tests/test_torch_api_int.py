"""The port's high-level API (on the CPU) against tfhe_tpu's, word for
word (tolerance 0), at PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST, seed 3: a
cheap cut of the slow FheInt8 case of tests/test_api.py; one add with both
packages in their single-program radix schedule (the reference's whole add
one `jax.jit` program, TFHE_TPU_FUSED_INTEGER=1; the port's fused=True);
the API keys carried across from the reference's arrays by
`weights.api_keys_from_reference`; and the server key being per thread."""

import threading

import numpy as np
import pytest

from tfhe_tpu import api as ref_api
from tfhe_tpu.params import PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST as REF_P

from tfhe_tpu_torch import api, weights
from tfhe_tpu_torch.integer import RadixCiphertext
from tfhe_tpu_torch.ops.torus import to_tensor
from tfhe_tpu_torch.shortint import ShortintBatch
from tfhe_tpu_torch.params import PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST as P
from torch_api_pair import make_pair
from torch_integer_pair import host_path_one_thread, same  # noqa: F401


@pytest.fixture(scope="module")
def keys(host_path_one_thread):  # noqa: F811
    return make_pair(REF_P, P, seed=3)


@pytest.fixture(autouse=True)
def server_keys_set(keys):
    keys.set_keys()


def test_fheint_ops_cut(keys):
    a, b = keys.enc("FheInt8", -42), keys.enc("FheInt8", 17)
    assert keys.dec(keys.run(lambda x, y: x + y, a, b)) == -25
    assert keys.dec(keys.run(lambda x: -x, a)) == 42
    assert keys.dec(keys.run(lambda x: x.abs(), a)) == 42
    assert keys.dec(keys.run(lambda x: x >> 2, a)) == -11  # arithmetic
    assert keys.dec(keys.run(lambda x, y: x < y, a, b)) is True
    assert keys.dec(keys.run(lambda x, y: x.max(y), a, b)) == 17


def test_fused_add_against_the_compiled_reference(monkeypatch):
    monkeypatch.setenv("TFHE_TPU_FUSED_INTEGER", "1")
    fused = make_pair(REF_P, P, seed=3, fused=True)
    a, b = fused.enc("FheUint8", 200), fused.enc("FheUint8", 100)
    out = fused.run(lambda x, y: x + y, a, b)
    assert fused.ref[1].integer_key._fused_ops is not None
    assert fused.port[1].integer_key._fused_ops._fns  # one program ran
    assert fused.dec(out) == (200 + 100) % 256


def test_keys_carried_across_from_the_reference(keys):
    ref_cks, ref_sks = keys.ref
    config = api.ConfigBuilder.default().use_custom_parameters(P).build()
    key = ref_cks.radix.key
    cks, sks = weights.api_keys_from_reference(
        config, key.lwe_sk.bits_array, key.glwe_sk.bits_array,
        np.asarray(ref_sks.integer_key.key.raw_bsk),
        np.asarray(ref_sks.integer_key.key.raw_ksk), seed=1, device="cpu")
    api.set_server_key(sks)
    ref_a = ref_api.FheUint8.encrypt(77, ref_cks)
    ref_b = ref_api.FheUint8.encrypt(50, ref_cks)

    def port_copy(x):
        blocks = x.inner.blocks
        return api.FheUint8(RadixCiphertext(ShortintBatch(
            data=to_tensor(np.asarray(blocks.data), "cpu"),
            degrees=blocks.degrees.copy(),
            message_modulus=blocks.message_modulus,
            carry_modulus=blocks.carry_modulus, noise=blocks.noise.copy())))

    a, b = port_copy(ref_a), port_copy(ref_b)
    assert a.decrypt(cks) == 77
    got = a - b
    same((ref_a - ref_b).inner, got.inner)
    assert got.decrypt(cks) == 27
    assert api.FheUint8.encrypt(9, cks).decrypt(cks) == 9


def test_server_key_is_per_thread(keys):
    seen = {}

    def other_thread():
        try:
            api.FheUint8.encrypt_trivial(1)
        except RuntimeError as e:
            seen["error"] = str(e)
        api.set_server_key(keys.port[1])
        seen["own"] = api._server_key() is keys.port[1].integer_key

    t = threading.Thread(target=other_thread)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    assert "set_server_key" in seen["error"] and seen["own"]
    # this thread's key is still its own
    assert api._server_key() is keys.port[1].integer_key
