"""The port's SHA-256 compression (tfhe_tpu_torch.examples.sha256_bool, on
the CPU) == tfhe_tpu.examples.sha256_bool, word for word (tolerance 0):
a 2-round compression over 16 encrypted message words at
BOOLEAN_SHA_TEST_PARAMETERS, with the words and seed of
tests/test_examples.py, each output word decrypted against the clear
circuit; its 144 gate batches on two torch threads."""

import pytest

from tfhe_tpu.examples import sha256_bool as ref_sb

from tfhe_tpu_torch.examples import sha256_bool as sb
from torch_boolean_pair import boolean_keys, same_words
from torch_boolean_pair import torch_threads  # noqa: F401

SEED = 808
TORCH_THREADS = 2
MASK = 0xFFFFFFFF


def _clear_compress(state, words, rounds):
    """Clear reduced-round SHA-256 compression (tests/test_examples.py)."""
    def rotr(x, n):
        return ((x >> n) | (x << (32 - n))) & MASK

    w = list(words)
    a, b, c, d, e, f, g, h = state
    for t in range(rounds):
        s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = (h + s1 + ch + sb.K[t] + w[t]) & MASK
        s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = (s0 + maj) & MASK
        h, g, f = g, f, e
        e = (d + t1) & MASK
        d, c, b = c, b, a
        a = (t1 + t2) & MASK
    return [(x + y) & MASK for x, y in zip(state, [a, b, c, d, e, f, g, h])]


@pytest.mark.usefixtures("torch_threads")
def test_sha256_two_round_compression():
    (rc, rs), (c, s) = boolean_keys(SEED)
    reng, eng = ref_sb.Sha256Fhe(rs), sb.Sha256Fhe(s)
    words = [((0x01234567 * (i + 1)) ^ 0x89ABCDEF) & MASK for i in range(16)]
    ref_enc, enc = ref_sb.encrypt_words(rc, words), sb.encrypt_words(c, words)
    for r, p in zip(ref_enc, enc):
        same_words(r, p)
    ref_out = reng.compress([reng.trivial_word(h) for h in ref_sb.H_INIT],
                            ref_enc, rounds=2)
    out = eng.compress([eng.trivial_word(h) for h in sb.H_INIT], enc,
                       rounds=2)
    for r, p in zip(ref_out, out):
        same_words(r, p)
    assert eng._gates == reng._gates == 144
    assert [sb.decrypt_word(c, wd) for wd in out] == \
        _clear_compress(sb.H_INIT, words, 2)
