"""The port's split family == tfhe_tpu.strings', word for word, at
PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST: split with a two-char separator (the
greedy sweep) and rsplit, on short strings from tests/test_split.py; every
part and the part count equal the reference's (tolerance 0), decrypt to
Rust's `str` result and leave the op's inputs unchanged
(torch_strings_pair.py)."""

import pytest

from tfhe_tpu import strings as ref_strings

from tfhe_tpu_torch import strings
from torch_integer_pair import host_path_one_thread  # noqa: F401
from torch_strings_pair import StringPair

SEED = 7


@pytest.fixture(scope="module")
def keys():
    return StringPair(ref_strings.gen_keys_test(seed=SEED),
                      strings.gen_keys_test(seed=SEED, device="cpu"))


def test_split_two_char_separator(keys):
    out = keys.op("split", keys.enc("encrypt_str", "aa"), "aa")
    assert keys.split(out) == ["", ""]


def test_rsplit(keys):
    out = keys.op("rsplit", keys.enc("encrypt_str", "a.b"), ".")
    assert keys.split(out) == ["b", "a"]
