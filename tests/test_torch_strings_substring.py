"""The port's string layer == tfhe_tpu.strings, word for word, at
PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST: the accessors at encrypted indices,
nth_encrypted and substring_encrypted (the cases of tests/test_strings.py),
every output decrypted to Python's `str` result and every op's inputs
unchanged (torch_strings_pair.py)."""

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


@pytest.mark.parametrize("n", [1, 4])
def test_nth_encrypted(keys, n):
    s = keys.enc("encrypt_str_padding", "hey!", 1)
    ch = keys.op("nth_encrypted", s, keys.enc_int(n))
    assert keys.port[0].decrypt_ascii_char(ch) == (ord("hey!"[n]) if n < 4
                                                   else 0)


@pytest.mark.parametrize("a,b,want", [(1, 3, "ey"), (3, 1, "")])
def test_substring_encrypted(keys, a, b, want):
    s = keys.enc("encrypt_str", "hey!")
    sub = keys.op("substring_encrypted", s, keys.enc_int(a), keys.enc_int(b))
    assert keys.string(sub) == want and keys.int(sub.length) == len(want)
