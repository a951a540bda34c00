"""The port's string layer == tfhe_tpu.strings, word for word, at
PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST: starts_with, ends_with, find and
rfind (the cases of tests/test_strings.py and test_strings_matrix.py, one
padding variant each), every output decrypted to Python's `str` result and
every op's inputs unchanged (torch_strings_pair.py)."""

import pytest

from tfhe_tpu import strings as ref_strings

from tfhe_tpu_torch import strings
from torch_integer_pair import host_path_one_thread  # noqa: F401
from torch_strings_pair import StringPair

SEED = 5


@pytest.fixture(scope="module")
def keys():
    return StringPair(ref_strings.gen_keys_test(seed=SEED),
                      strings.gen_keys_test(seed=SEED, device="cpu"))


def test_starts_ends_with(keys):
    h = keys.enc("encrypt_str", "hello")
    assert keys.bool(keys.op("starts_with", h, "he")) is True
    assert keys.bool(keys.op("starts_with", h, "el")) is False
    assert keys.bool(keys.op("ends_with", h, "llo")) is True
    hp = keys.enc("encrypt_str_padding", "hey", 1)
    assert keys.bool(keys.op("ends_with", hp, "ey")) is True


def test_find_rfind(keys):
    h = keys.enc("encrypt_str", "hello")
    found, idx = keys.op("find", h, "l")
    assert keys.bool(found) is True and keys.int(idx) == 2
    found, idx = keys.op("rfind", h, "l")
    assert keys.bool(found) is True and keys.int(idx) == 3
    found, _ = keys.op("find", h, "z")
    assert keys.bool(found) is False


def test_find_random_padding(keys):
    h = keys.enc("encrypt_str_random_padding", "abca", 1, rng_seed=9)
    found, idx = keys.op("find", h, "ca")
    assert keys.bool(found) is True and keys.int(idx) == 2
