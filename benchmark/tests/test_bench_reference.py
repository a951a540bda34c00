"""The plain reference agrees with clear arithmetic and Python's str, its
LWE round trip is exact, and its control differs (CPU)."""

import random

import pytest
import torch

from benchmark.reference import clear, lwe

ENC = lwe.Encoding(4, 4, 742, 1, 2048, 2.9403601535432533e-16)


@pytest.mark.parametrize("op", clear.RADIX_OPS + clear.BOOL_OPS)
def test_integer_ops_are_python_arithmetic(op):
    rng = random.Random(op)
    py = {"add": lambda a, b, c: (a + b) % 2 ** 64,
          "sub": lambda a, b, c: (a - b) % 2 ** 64,
          "mul": lambda a, b, c: (a * b) % 2 ** 64,
          "bitxor": lambda a, b, c: a ^ b, "max": lambda a, b, c: max(a, b),
          "if_then_else": lambda a, b, c: a if c else b,
          "eq": lambda a, b, c: int(a == b), "lt": lambda a, b, c: int(a < b)}
    for _ in range(200):
        a, b = rng.getrandbits(64), rng.getrandbits(64)
        c = rng.random() < 0.5
        assert clear.integer_op(op, a, b, c) == py[op](a, b, c)
        ans = clear.integer_answer(op, a, b, c, 32, 4)
        v = py[op](a, b, c)
        if op in clear.BOOL_OPS:
            assert ans == [v]
        else:
            assert sum(d * 4 ** i for i, d in enumerate(ans)) == v
            assert all(0 <= d < 4 for d in ans)


def test_integer_control_differs():
    rng = random.Random(5)
    wrong = 0
    for op in clear.RADIX_OPS + clear.BOOL_OPS:
        for _ in range(20):
            a, b = rng.getrandbits(64), rng.getrandbits(64)
            wrong += (clear.integer_answer(op, a, b, True, 32, 4) !=
                      clear.integer_answer(op, a, b, True, 32, 4, bits=32))
    assert wrong > 100


def test_strings_are_python_str():
    rng = random.Random(9)
    for _ in range(500):
        text = "".join(chr(rng.randint(97, 100))
                       for _ in range(rng.randint(2, 16)))
        plen = rng.randint(1, 4)
        pat = "".join(chr(rng.randint(97, 100)) for _ in range(plen))
        if plen > 16:
            continue
        assert clear.contains_answer(text, pat, 16) == [int(pat in text)]
        found = clear.find_answer(text, pat, 16)
        idx = text.find(pat)
        assert found[0] == int(idx >= 0)
        assert found[1:] == [int(o == idx) for o in range(16 - plen + 1)]


def test_string_control_matches_more():
    # '0' is 0x30: on 4 bits it equals the padding's zero chars
    assert clear.contains_answer("abc", "c0", 8) == [0]
    assert clear.contains_answer("abc", "c0", 8, char_bits=4) == [1]


def test_lwe_round_trip():
    g = lwe.generator(2 ** 31 + 3, 1, "cpu")
    small, glwe = lwe.draw_secret_keys(ENC, 2 ** 31 + 3, "cpu")
    assert small.shape == (742,) and glwe.shape == (1, 2048)
    assert 0.4 < glwe.float().mean() < 0.6
    big = glwe.reshape(-1)
    values = torch.arange(32).repeat(8)
    cts = lwe.encrypt(ENC, big, values, g)
    assert cts.shape == (256, 2049)
    got, err = lwe.decrypt(ENC, big, cts, rows_per_block=100)
    assert torch.equal(got, values)
    assert float(err.max()) < 1e-6
    # a wrong key decodes garbage
    other, _ = lwe.decrypt(ENC, 1 - big, cts)
    assert not torch.equal(other, values)


def test_uniform_words_use_all_bits():
    g = lwe.generator(1, 1, "cpu")
    w = lwe.uniform_words((4096,), g, "cpu")
    assert (w < 0).any() and (w > 0).any()
    assert ((w >> 32) & 0xFFFFFFFF).unique().numel() > 4000
