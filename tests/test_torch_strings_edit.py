"""The port's string layer == tfhe_tpu.strings, word for word, at
PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST: concat, repeat, substring with
clear bounds, nth_clear, replace_char and both push_padding_to_end
schedules (the cases of tests/test_strings.py), every output decrypted to
Python's `str` result and every op's inputs unchanged
(torch_strings_pair.py)."""

import pytest

from tfhe_tpu import strings as ref_strings

from tfhe_tpu_torch import strings
from torch_integer_pair import host_path_one_thread  # noqa: F401
from torch_strings_pair import StringPair, assert_unchanged, same, snapshot

SEED = 5


@pytest.fixture(scope="module")
def keys():
    return StringPair(ref_strings.gen_keys_test(seed=SEED),
                      strings.gen_keys_test(seed=SEED, device="cpu"))


def test_concat_repeat_substring(keys):
    c = keys.op("concat", keys.enc("encrypt_str", "ab"),
                keys.enc("encrypt_str", "cd"))
    assert keys.string(c) == "abcd" and c.length == 4
    assert keys.string(keys.op("repeat", keys.enc("encrypt_str", "ab"),
                               3)) == "ababab"
    assert keys.string(keys.op("substring", keys.enc("encrypt_str", "hello"),
                               1, 4)) == "ell"
    sub = keys.op("substring", keys.enc("encrypt_str_padding", "hello", 1),
                  1, 4)
    assert keys.string(sub) == "ell" and keys.int(sub.length) == 3


def test_nth_clear(keys):
    s = keys.enc("encrypt_str_padding", "hey", 1)
    for n in (0, 2, 4):
        got = keys.port[0].decrypt_ascii_char(keys.op("nth_clear", s, n))
        assert got == (ord("hey"[n]) if n < 3 else 0)


def test_replace_char(keys):
    out = keys.op("replace_char", keys.enc("encrypt_str", "banana"), "a", "o")
    assert keys.string(out) == "bonono"


@pytest.mark.parametrize("schedule", ["bubble", "compact"])
def test_push_padding_to_end(keys, schedule):
    """Both schedules against the reference's own (a CPU key runs the
    bubble one from push_padding_to_end, a card's key the compact one)."""
    ref, port = keys.enc("encrypt_str_random_padding", "hi", 2, rng_seed=4)
    name = f"_push_padding_{schedule}"
    snap = snapshot([port])
    out = getattr(keys.port[1], name)(port)
    assert_unchanged([port], snap, name)
    same(getattr(keys.ref[1], name)(ref), out)
    if schedule == "bubble":
        same(ref, port)
        same(keys.ref[1].push_padding_to_end(ref),
             keys.port[1].push_padding_to_end(port))
    assert out.padding == strings.Padding.FINAL
    assert keys.string(out) == "hi"
    assert [keys.port[0].decrypt_ascii_char(c) for c in out.content] == \
        [ord(c) for c in "hi"] + [0, 0]

