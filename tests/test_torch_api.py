"""The port's high-level API (tfhe_tpu_torch.api, on the CPU) == tfhe_tpu's
API, word for word (tolerance 0), at PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST
with seed 3: the six tier-1 cases of tests/test_api.py, every operator's
result compared with its degrees and noise levels before it is decrypted
against the clear value (torch_api_pair.py; the reference on its host
radix path)."""

import pytest

from tfhe_tpu.params import PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST as REF_P

import tfhe_tpu_torch
from tfhe_tpu_torch import api
from tfhe_tpu_torch.params import PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST as P
from torch_api_pair import make_pair
from torch_integer_pair import host_path_one_thread  # noqa: F401


@pytest.fixture(scope="module")
def keys(host_path_one_thread):  # noqa: F811
    return make_pair(REF_P, P, seed=3)


@pytest.fixture(autouse=True)
def server_keys_set(keys):
    keys.set_keys()


def test_readme_example_shape(keys):
    """The reference README flow: encrypt two values, *, +, -, decrypt."""
    clear_a, clear_b = 27, 128
    a, b = keys.enc("FheUint8", clear_a), keys.enc("FheUint8", clear_b)
    assert keys.dec(keys.run(lambda x, y: x * y, a, b)) == \
        (clear_a * clear_b) % 256
    assert keys.dec(keys.run(lambda x, y: x + y, a, b)) == \
        (clear_a + clear_b) % 256
    assert keys.dec(keys.run(lambda x, y: x - y, a, b)) == \
        (clear_a - clear_b) % 256


def test_operators(keys):
    a, b = keys.enc("FheUint8", 0b1100), keys.enc("FheUint8", 0b1010)
    for fn, want in ((lambda x, y: x & y, 0b1000),
                     (lambda x, y: x | y, 0b1110),
                     (lambda x, y: x ^ y, 0b0110),
                     (lambda x, y: ~x, 0b11110011),
                     (lambda x, y: x << 2, 0b110000),
                     (lambda x, y: x >> 1, 0b110),
                     (lambda x, y: -x, 256 - 12),
                     (lambda x, y: x + 5, 17),
                     (lambda x, y: x * 3, 36)):
        assert keys.dec(keys.run(fn, a, b)) == want


def test_comparisons_and_select(keys):
    a, b = keys.enc("FheUint8", 12), keys.enc("FheUint8", 30)
    for fn, want in ((lambda x, y: x < y, True),
                     (lambda x, y: x == y, False),
                     (lambda x, y: x.eq(12), True),
                     (lambda x, y: x >= y, False)):
        assert keys.dec(keys.run(fn, a, b)) is want
    assert keys.dec(keys.run(lambda x, y: x.max(y), a, b)) == 30
    assert keys.dec(keys.run(lambda x, y: x.min(5), a, b)) == 5
    cond = keys.run(lambda x, y: x < y, a, b)
    assert keys.dec(keys.run(lambda c, x, y: c.if_then_else(x, y),
                             cond, a, b)) == 12


def test_fhebool_ops(keys):
    t, f = keys.enc("FheBool", True), keys.enc("FheBool", False)
    assert keys.dec(keys.run(lambda x, y: x & y, t, f)) is False
    assert keys.dec(keys.run(lambda x, y: x | y, t, f)) is True
    assert keys.dec(keys.run(lambda x, y: x ^ y, t, t)) is False
    assert keys.dec(keys.run(lambda x: ~x, f)) is True


def test_trivial_encrypt(keys):
    t = keys.trivial("FheUint8", 99)
    assert keys.dec(t) == 99
    a = keys.enc("FheUint8", 1)
    assert keys.dec(keys.run(lambda x, y: x + y, t, a)) == 100


def test_wide_types_round_trip(keys):
    """FheUint64/128/256 encrypt/decrypt + a cheap op each (ref:
    high_level_api macro expansion covers all widths); the top-level
    names are the API's."""
    v64 = (1 << 63) | 12345
    a = keys.enc("FheUint64", v64)
    assert keys.dec(a) == v64
    assert keys.dec(keys.run(lambda x: x + 1, a)) == (v64 + 1) % (1 << 64)
    v128 = (1 << 120) + 99
    assert keys.dec(keys.enc("FheUint128", v128)) == v128
    v256 = (1 << 250) + 7
    assert keys.dec(keys.enc("FheUint256", v256)) == v256
    assert keys.dec(keys.enc("FheInt64", -(1 << 40))) == -(1 << 40)
    assert tfhe_tpu_torch.FheUint64 is api.FheUint64
    assert tfhe_tpu_torch.ClientKey is tfhe_tpu_torch.shortint.ClientKey
