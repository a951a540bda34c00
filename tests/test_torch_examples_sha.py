"""The port's SHA-256 over encrypted booleans (tfhe_tpu_torch.examples.
sha256_bool, on the CPU) == tfhe_tpu.examples.sha256_bool, word for word
(tolerance 0), at BOOLEAN_SHA_TEST_PARAMETERS with the seed of
tests/test_examples.py: the adders, the rotations and shifts, and the
message padding; every word decrypted against the clear result.  (The
2-round compression: test_torch_examples_sha_rounds.py.)"""

import pytest
import torch

from tfhe_tpu.examples import sha256_bool as ref_sb

from tfhe_tpu_torch.examples import sha256_bool as sb
from torch_boolean_pair import boolean_keys, same_words
from torch_boolean_pair import torch_threads  # noqa: F401

SEED = 808
MASK = 0xFFFFFFFF


@pytest.fixture(scope="module")
def engines(torch_threads):  # noqa: F811
    (rc, rs), (c, s) = boolean_keys(SEED)
    return (rc, ref_sb.Sha256Fhe(rs)), (c, sb.Sha256Fhe(s))


def _enc(engines, value):
    (rc, _), (c, _) = engines
    ref = rc.encrypt_batch(ref_sb._word_bits_lsb(value))
    port = c.encrypt_batch(sb._word_bits_lsb(value))
    same_words(ref, port)
    return ref, port


def _check(engines, ref_word, port_word, want):
    same_words(ref_word, port_word)
    assert port_word.shape == (sb.WORD, engines[1][1].lwe_size)
    assert sb.decrypt_word(engines[1][0], port_word) == want


def test_adders(engines):
    (_, reng), (_, eng) = engines
    ra, pa = _enc(engines, 0xDEADBEEF)
    rb, pb = _enc(engines, 0xFFFFFFFF)
    _check(engines, reng.add(ra, rb), eng.add(pa, pb),
           (0xDEADBEEF + 0xFFFFFFFF) % 2 ** 32)
    same_words(reng.trivial_word(0x42), eng.trivial_word(0x42))
    _check(engines, reng.add_many([ra, rb, reng.trivial_word(0x42), ra]),
           eng.add_many([pa, pb, eng.trivial_word(0x42), pa]),
           (2 * 0xDEADBEEF + 0xFFFFFFFF + 0x42) % 2 ** 32)
    assert eng._gates == reng._gates


def test_rot_shift_free_ops(engines):
    (_, reng), (_, eng) = engines
    x = 0x9ABCDEF0
    rx, px = _enc(engines, x)
    before = px.clone()
    _check(engines, reng.rotr(rx, 7), eng.rotr(px, 7),
           ((x >> 7) | (x << 25)) & MASK)
    _check(engines, reng.shr(rx, 3), eng.shr(px, 3), x >> 3)
    _check(engines, reng._shift_up(rx, 5, True), eng._shift_up(px, 5, True),
           ((x << 5) | 0x1F) & MASK)
    # stacked words move on their bit axis; the input is left as it was
    stacked = eng.rotr(torch.stack([px, px]), 13)
    assert torch.equal(stacked[1], eng.rotr(px, 13))
    assert torch.equal(px, before)


def test_pad_message():
    words = sb.pad_message(b"abc")
    assert words == ref_sb.pad_message(b"abc")
    assert len(words) == 16 and words[0] == 0x61626380 and words[15] == 24
