"""The port's string layer (tfhe_tpu_torch.strings, on the CPU) ==
tfhe_tpu.strings, word for word, at PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST
(4 blocks a char), on strings of up to 6 characters: a few cases of each
op family of tests/test_strings.py and test_strings_matrix.py
(comparisons, contains / starts_with / ends_with, find / rfind, case
mapping), one padding variant each.  Every output equals the reference's
(tolerance 0) with its degrees and noise levels, decrypts to Python's
`str` result, and leaves the op's inputs unchanged (torch_strings_pair.py).
"""

import pytest

from tfhe_tpu import strings as ref_strings
from tfhe_tpu.strings.ciphertext import FheAsciiChar as RefChar

from tfhe_tpu_torch import strings
from tfhe_tpu_torch.strings.ciphertext import FheAsciiChar
from torch_integer_pair import host_path_one_thread  # noqa: F401
from torch_strings_pair import StringPair, same

SEED = 5


@pytest.fixture(scope="module")
def keys():
    return StringPair(ref_strings.gen_keys_test(seed=SEED),
                      strings.gen_keys_test(seed=SEED, device="cpu"))


def test_encrypt_decrypt_roundtrip(keys):
    for fn, args, want in (("encrypt_str", ("hello",), "hello"),
                           ("encrypt_str", ("",), ""),
                           ("encrypt_str_padding", ("hi", 3), "hi")):
        ref, port = keys.enc(fn, *args)
        same(ref, port)
        assert keys.string(port) == want
    # the default rng of random padding places the zeros as the reference
    ref = keys.ref[0].encrypt_str_random_padding("ab", 2)
    port = keys.port[0].encrypt_str_random_padding("ab", 2)
    same(ref, port)
    assert keys.string(port) == "ab"


@pytest.mark.parametrize("text,pattern", [("Abc", "Abc"), ("Abc", "Abd"),
                                          ("Abc", "Ab")])
def test_eq_ne_clear(keys, text, pattern):
    s = keys.enc("encrypt_str", text)
    assert keys.bool(keys.op("eq", s, pattern)) == (text == pattern)
    assert keys.bool(keys.op("ne", s, pattern)) == (text != pattern)


def test_eq_encrypted_and_padded(keys):
    p1 = keys.enc("encrypt_str_padding", "hi", 2)
    assert keys.bool(keys.op("eq", p1, keys.enc("encrypt_str", "hi")))


@pytest.mark.parametrize("a,b", [("abc", "abd"), ("b", "ab")])
def test_lexicographic(keys, a, b):
    s = keys.enc("encrypt_str", a)
    for op, f in (("lt", lambda x, y: x < y), ("le", lambda x, y: x <= y),
                  ("gt", lambda x, y: x > y), ("ge", lambda x, y: x >= y)):
        assert keys.bool(keys.op(op, s, b)) == f(a, b), (op, a, b)


def test_lexicographic_encrypted_padded(keys):
    s = keys.enc("encrypt_str_padding", "abc", 1)
    t = keys.enc("encrypt_str", "abd")
    assert keys.bool(keys.op("lt", s, t)) is True


@pytest.mark.parametrize("pattern,kind", [("ell", "clear"), ("elo", "clear"),
                                          ("llo", "encrypted"),
                                          ("l", "char")])
def test_contains(keys, pattern, kind):
    h = keys.enc("encrypt_str", "hello")
    if kind == "encrypted":
        pat = keys.enc("encrypt_str", pattern)
    elif kind == "char":
        ref_c, port_c = keys.enc_int(ord(pattern))
        pat = (RefChar(ref_c), FheAsciiChar(port_c))
    else:
        pat = pattern
    assert keys.bool(keys.op("contains", h, pat)) == (pattern in "hello")


def test_contains_padded_pattern(keys):
    h = keys.enc("encrypt_str", "xcab")
    pat = keys.enc("encrypt_str_padding", "ca", 1)
    assert keys.bool(keys.op("contains", h, pat)) is True
