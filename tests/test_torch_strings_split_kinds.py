"""The port's split family == tfhe_tpu.strings', word for word, at
PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST: split_terminator, split_inclusive and
split_ascii_whitespace, on short strings from tests/test_split.py; every
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


def test_split_terminator_inclusive(keys):
    s = keys.enc("encrypt_str", "a.")
    assert keys.split(keys.op("split_terminator", s, ".")) == ["a"]
    assert keys.split(keys.op("split_inclusive", s, ".")) == ["a."]


def test_split_ascii_whitespace(keys):
    out = keys.op("split_ascii_whitespace", keys.enc("encrypt_str", " ab"))
    assert keys.split(out) == ["ab"]
