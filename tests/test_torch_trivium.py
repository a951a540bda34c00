"""The port's Trivium and Kreyvium (tfhe_tpu_torch.apps.trivium): the
clear streams meet the known-answer vectors of tests/test_trivium.py
(avr-crypto-lib trivium-80.80), and the FHE stream on the CPU ==
tfhe_tpu.apps.trivium's word for word (tolerance 0) at
BOOLEAN_SHA_TEST_PARAMETERS, seed 606: through a subclass with one
warm-up wave on both sides (the full 1152-step warm-up runs on the card,
in chip_smoke.py), the first 64 keystream ciphertexts equal and decrypted
to the clear stream's; and transciphering."""

import numpy as np
import pytest
import torch

from tfhe_tpu.apps import trivium as ref_tv

from tfhe_tpu_torch.apps import trivium as tv
from torch_boolean_pair import boolean_keys, same_words
from torch_boolean_pair import torch_threads  # noqa: F401

SEED = 606


def to_hex(bits):
    bits = [int(b) for b in bits]
    return "".join(
        f"{sum(b << j for j, b in enumerate(bits[i:i + 8])):02X}"
        for i in range(0, len(bits), 8))


class OneWaveTrivium(tv.TriviumStream):
    WARMUP_WAVES = 1


class RefOneWaveTrivium(ref_tv.TriviumStream):
    WARMUP_WAVES = 1


class OneWaveKreyvium(tv.KreyviumStream):
    WARMUP_WAVES = 1


class RefOneWaveKreyvium(ref_tv.KreyviumStream):
    WARMUP_WAVES = 1


def test_trivium_known_answers():
    s = tv.trivium_clear([0] * 80, [0] * 80)
    bits = torch.cat([s.next_64() for _ in range(8)])
    assert bits.dtype == torch.bool
    assert to_hex(bits) == (
        "FBE0BF265859051B517A2E4E239FC97F563203161907CF2DE7A8790FA1B2E9CD"
        "F75292030268B7382B4C1A759AA2599A285549986E74805903801A4CB5A5D4F2")
    key = [0] * 80
    key[7] = 1
    assert to_hex(tv.trivium_clear(key, [0] * 80).next_64()).startswith(
        "38EB86FF730D7A9C")
    iv = [0] * 80
    iv[7] = 1
    assert to_hex(tv.trivium_clear([0] * 80, iv).next_64()).startswith(
        "F8901736640549E3")


def test_kreyvium_known_answers():
    assert to_hex(tv.kreyvium_clear([0] * 128, [0] * 128).next_64()) == \
        "26DCF1F4BC0F1922"
    key = [0] * 128
    key[0] = 1
    assert to_hex(tv.kreyvium_clear(key, [0] * 128).next_64()) == \
        "4FD421D4DA3D2C8A"


@pytest.fixture(scope="module")
def keys(torch_threads):  # noqa: F811
    return boolean_keys(SEED)


@pytest.mark.parametrize("cipher", ["trivium", "kreyvium"])
def test_fhe_stream_matches_reference_and_clear(keys, cipher):
    (rc, rs), (c, s) = keys
    width = 80 if cipher == "trivium" else 128
    rng = np.random.default_rng(5)
    key = rng.integers(0, 2, width).tolist()
    iv = rng.integers(0, 2, width).tolist()
    ref_cls, cls = {"trivium": (RefOneWaveTrivium, OneWaveTrivium),
                    "kreyvium": (RefOneWaveKreyvium, OneWaveKreyvium)}[cipher]
    ref_key = rc.encrypt_batch(np.asarray(key, dtype=bool))
    enc_key = c.encrypt_batch(np.asarray(key, dtype=bool))
    same_words(ref_key, enc_key)
    ref_stream = ref_cls(ref_tv.FheBits(rs), np.asarray(ref_key), iv)
    stream = cls(tv.FheBits(s), enc_key, iv)
    for reg in ("a", "b", "c"):
        same_words(getattr(ref_stream, reg), getattr(stream, reg))
    z = stream.next_64()
    same_words(ref_stream.next_64(), z)
    assert z.shape == (64, tv.FheBits(s).lwe_size)
    clear = cls(tv.ClearBits(), tv.ClearBits().const(key), iv)
    assert np.array_equal(c.decrypt_batch(z), clear.next_64().numpy())


def test_transciphering(keys):
    """The client masks data with the clear keystream; the server XORs the
    FHE keystream in and holds the encrypted plaintext bits."""
    (_, _), (c, s) = keys
    rng = np.random.default_rng(7)
    key = rng.integers(0, 2, 80).tolist()
    iv = rng.integers(0, 2, 80).tolist()
    data = int(rng.integers(0, 1 << 63))
    data_bits = [(data >> i) & 1 for i in range(64)]
    ks = OneWaveTrivium(tv.ClearBits(), tv.ClearBits().const(key),
                        iv).next_64()
    masked = [int(b) ^ int(k) for b, k in zip(data_bits, ks)]
    server = OneWaveTrivium(tv.FheBits(s),
                            c.encrypt_batch(np.asarray(key, dtype=bool)), iv)
    got_bits = c.decrypt_batch(tv.trans_decrypt_64(s, server, masked))
    assert sum(int(b) << i for i, b in enumerate(got_bits)) == data
    with pytest.raises(TypeError):
        tv.trans_decrypt_64(s, OneWaveTrivium(tv.ClearBits(),
                                              tv.ClearBits().const(key), iv),
                            masked)
