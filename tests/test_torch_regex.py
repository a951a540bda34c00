"""The port's regex engine (tfhe_tpu_torch.examples.regex_engine, on the
CPU) == tfhe_tpu.examples.regex_engine, word for word (tolerance 0), on
the string keys of tests/test_examples.py (gen_keys_test, seed 404): four
patterns of its table (literals, anchors, a class) on texts of 5
characters, each match bit's words, degree and noise level equal before
it is decrypted against the expected answer; a padded string refused.
(The other six: test_torch_regex_more.py, test_torch_regex_alt.py.)"""

import pytest

from tfhe_tpu import strings as ref_strings
from tfhe_tpu.examples import regex_engine as ref_re

from tfhe_tpu_torch import strings
from tfhe_tpu_torch.examples import regex_engine as re_fhe
from torch_integer_pair import host_path_one_thread, same  # noqa: F401

SEED = 404
# tests/test_examples.py:159-170
CASES = [
    ("hello", "/ell/", True),
    ("hello", "/^ell/", False),
    ("hello", "/lo$/", True),
    ("hello", "/^h[a-e]llo$/", True),
    ("hello", "/^h[^a-e]llo$/", False),
    ("heo", "/hel*o/", True),
    ("heo", "/hel+o/", False),
    ("hello", "/(cat|hel)lo/", True),
    ("HELLO", "/hello/i", True),
    ("aab", "/^a{1,2}b$/", True),
]


@pytest.fixture(scope="module")
def string_keys(host_path_one_thread):  # noqa: F811
    return (ref_strings.gen_keys_test(seed=SEED),
            strings.gen_keys_test(seed=SEED, device="cpu"))


def check(string_keys, text, pattern, want):
    (rc, rs), (c, s) = string_keys
    ref_out = ref_re.has_match(rs, rc.encrypt_str(text), pattern)
    out = re_fhe.has_match(s, c.encrypt_str(text), pattern)
    same(ref_out, out)
    assert c.integer_key.decrypt_bool(out) is want


@pytest.mark.parametrize("text,pattern,want", CASES[:4])
def test_regex(string_keys, text, pattern, want):
    check(string_keys, text, pattern, want)


def test_regex_rejects_padded(string_keys):
    _, (c, s) = string_keys
    with pytest.raises(ValueError):
        re_fhe.has_match(s, c.encrypt_str_padding("hi", 2), "/hi/")
    for pattern in ("/a|b/", "/^h[^a-e]l{1,2}o$/i"):
        got, want = (m.compile_pattern(pattern) for m in (re_fhe, ref_re))
        assert got[:2] == want[:2] and got[3:] == want[3:]
        assert [(a, b, c.ranges, c.negated) for a, b, c in got[2]] == \
            [(a, b, c.ranges, c.negated) for a, b, c in want[2]]
