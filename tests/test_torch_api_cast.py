"""The port's high-level `cast_into` (on the CPU) == tfhe_tpu's, word for
word (tolerance 0): the five width and signedness casts of
tests/test_casting.py:69-132 at PARAM_MESSAGE_2_CARRY_2_TEST, seed 77,
every result's blocks, degrees and noise levels compared before it is
decrypted (torch_api_pair.py; the reference on its host radix path)."""

import pytest

from tfhe_tpu import api as ref_api
from tfhe_tpu.params import PARAM_MESSAGE_2_CARRY_2_TEST as REF_P

from tfhe_tpu_torch import api
from tfhe_tpu_torch.params import PARAM_MESSAGE_2_CARRY_2_TEST as P
from torch_api_pair import make_pair
from torch_integer_pair import host_path_one_thread  # noqa: F401


@pytest.fixture(scope="module")
def keys(host_path_one_thread):  # noqa: F811
    return make_pair(REF_P, P, seed=77)


@pytest.fixture(autouse=True)
def server_keys_set(keys):
    keys.set_keys()


def _cast(keys, pair, type_name):
    return (pair[0].cast_into(getattr(ref_api, type_name)),
            pair[1].cast_into(getattr(api, type_name)))


def test_hl_cast_narrow(keys):
    b = _cast(keys, keys.enc("FheUint16", 0xABCD), "FheUint8")
    assert type(b[1]) is api.FheUint8
    assert keys.dec(b) == 0xCD


def test_hl_cast_widen_unsigned(keys):
    b = _cast(keys, keys.enc("FheUint8", 200), "FheUint16")
    assert keys.dec(b) == 200
    assert keys.dec(keys.run(lambda x: x + 100, b)) == 300  # no 8-bit wrap


def test_hl_cast_widen_signed(keys):
    b = _cast(keys, keys.enc("FheInt8", -5), "FheInt16")
    assert type(b[1]) is api.FheInt16
    assert keys.dec(b) == -5
    assert keys.dec(_cast(keys, keys.enc("FheInt8", 100), "FheInt16")) == 100


def test_hl_cast_signed_unsigned(keys):
    assert keys.dec(_cast(keys, keys.enc("FheInt8", -1), "FheUint8")) == 255
    assert keys.dec(_cast(keys, keys.enc("FheUint8", 255), "FheInt8")) == -1


def test_hl_cast_after_arithmetic(keys):
    """Cast must propagate carries first (dirty blocks would corrupt the
    trim)."""
    a, b = keys.enc("FheUint16", 300), keys.enc("FheUint16", 100)
    c = _cast(keys, keys.run(lambda x, y: x + y, a, b), "FheUint8")
    assert keys.dec(c) == 400 % 256
