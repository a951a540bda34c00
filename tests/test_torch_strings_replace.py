"""The port's replace (a split and a join) and splitn with a clear count ==
tfhe_tpu.strings', word for word, at PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST,
on cases of tests/test_split.py: every output and encrypted length equal
the reference's (tolerance 0), decrypt to Python's / Rust's `str` result
and leave the op's inputs unchanged (torch_strings_pair.py)."""

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


def test_replace(keys):
    out = keys.op("replace", keys.enc("encrypt_str", "a.b"), ".", "+")
    assert keys.string(out) == "a+b" and keys.int(out.length) == 3


def test_splitn(keys):
    out = keys.op("splitn", keys.enc("encrypt_str", "a.b"), 1, ".")
    assert keys.split(out) == ["a.b"]
