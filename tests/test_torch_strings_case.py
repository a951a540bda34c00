"""The port's string layer == tfhe_tpu.strings, word for word, at
PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST: case mapping, length, trim and strip
(the cases of tests/test_strings.py and test_strings_matrix.py, one padding
variant each), every output decrypted to Python's `str` result and every
op's inputs unchanged (torch_strings_pair.py)."""

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


def test_case_ops(keys):
    s = keys.enc("encrypt_str", "aZ9")
    assert keys.string(keys.op("to_uppercase", s)) == "AZ9"
    assert keys.string(keys.op("to_lowercase", s)) == "az9"
    assert keys.bool(keys.op("eq_ignore_case", keys.enc("encrypt_str", "ab"),
                             "Ab")) is True


def test_len_is_empty(keys):
    assert keys.op("len_", keys.enc("encrypt_str", "hello")) == 5
    assert keys.bool(keys.op("is_empty", keys.enc("encrypt_str", ""))) is True
    assert keys.bool(keys.op("is_empty",
                             keys.enc("encrypt_str_padding", "a", 1))) is False


def test_trim(keys):
    assert keys.string(keys.op("trim_end", keys.enc("encrypt_str", "hi  "))) \
        == "hi"
    assert keys.string(keys.op("trim_start",
                               keys.enc("encrypt_str", " hi"))) == "hi"
    out = keys.op("trim_end", keys.enc("encrypt_str_padding", "ok ", 1))
    assert keys.string(out) == "ok" and keys.int(out.length) == 2


def test_trim_both_ends(keys):
    out = keys.op("trim", keys.enc("encrypt_str", " hi "))
    assert keys.string(out) == "hi" and keys.int(out.length) == 2


def test_strip(keys):
    m, sp = keys.op("strip_prefix", keys.enc("encrypt_str", "foob"), "fo")
    assert keys.bool(m) is True and keys.string(sp) == "ob"
    m, sp = keys.op("strip_prefix", keys.enc("encrypt_str", "foob"), "ob")
    assert keys.bool(m) is False and keys.string(sp) == "foob"
    m, ss = keys.op("strip_suffix", keys.enc("encrypt_str", "foob"), "ob")
    assert keys.bool(m) is True and keys.string(ss) == "fo"
