"""Port's CSPRNG (tfhe_tpu_torch.prng) == tfhe_tpu.prng, byte for byte,
on both of the port's AES backends (native g++ build and numpy)."""

import os

import numpy as np
import pytest

from tfhe_tpu.prng import AesCtrStream as RefStream
from tfhe_tpu.prng import Seeder as RefSeeder
from tfhe_tpu.prng.aes import encrypt_blocks_numpy, key_expansion
from tfhe_tpu.prng.generators import EncryptionRandomGenerator as RefEnc
from tfhe_tpu.prng.generators import SecretRandomGenerator as RefSec

from tfhe_tpu_torch import prng
from tfhe_tpu_torch._native import BUILD_ROOT

BACKENDS = ("native", "numpy")
KEY = 0x0123456789ABCDEF0123456789ABCDEF


def _ref_blocks(key, start, count):
    """Reference AES-CTR through its always-available numpy path."""
    from tfhe_tpu.prng.aes import counters_to_blocks

    rk = key_expansion(key.to_bytes(16, "little"))
    return encrypt_blocks_numpy(rk, counters_to_blocks(start, count)).reshape(-1)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("start", [0, 5, (1 << 64) - 3, (1 << 128) - 2])
def test_aes_blocks_match_reference(backend, start):
    aes = prng.Aes128(KEY, backend=backend)
    assert aes.backend == backend
    assert np.array_equal(aes.ctr_blocks(start, 37), _ref_blocks(KEY, start, 37))


def test_aes_fips197_vector():
    from tfhe_tpu_torch.prng.aes import encrypt_blocks_numpy as enc, key_expansion as ke

    pt = np.frombuffer(bytes.fromhex("00112233445566778899aabbccddeeff"),
                       dtype=np.uint8).reshape(1, 16).copy()
    assert enc(ke(bytes(range(16))), pt).tobytes().hex() == \
        "69c4e0d86a7b0430d8cdb78070b4c55a"


def test_native_library_builds_outside_the_package_sources():
    path = prng.native_library()._name
    assert os.path.dirname(os.path.dirname(path)) == BUILD_ROOT
    csrc = os.path.join(os.path.dirname(prng.__file__), "csrc")
    assert sorted(os.listdir(csrc)) == ["aes_csprng.cpp"]


def test_unknown_backend_raises():
    with pytest.raises(ValueError):
        prng.Aes128(1, backend="fast")


@pytest.mark.parametrize("backend", BACKENDS)
def test_stream_bytes_match_reference(backend):
    ours = prng.AesCtrStream(42, backend=backend)
    ref = RefStream(42)
    for n in (1, 15, 16, 17, 100, 3):
        assert np.array_equal(ours.next_bytes(n), ref.next_bytes(n))
    assert ours.current == ref.current
    assert ours.backend == backend


@pytest.mark.parametrize("backend", BACKENDS)
def test_fork_tree_matches_reference(backend):
    ours = prng.AesCtrStream(7, backend=backend)
    ref = RefStream(7)
    ours.next_bytes(5), ref.next_bytes(5)
    for kid_o, kid_r in zip(ours.try_fork(3, 100), ref.try_fork(3, 100)):
        assert kid_o.backend == backend
        grand_o, grand_r = kid_o.try_fork(2, 40), kid_r.try_fork(2, 40)
        for g_o, g_r in zip(grand_o, grand_r):
            assert np.array_equal(g_o.next_bytes(40), g_r.next_bytes(40))
        assert np.array_equal(kid_o.next_bytes(20), kid_r.next_bytes(20))
        with pytest.raises(prng.ForkError):
            kid_o.next_bytes(1)
    assert np.array_equal(ours.next_bytes(33), ref.next_bytes(33))


def test_seeders_and_generators_match_reference():
    ours, ref = prng.Seeder(99), RefSeeder(99)
    assert [ours.seed() for _ in range(3)] == [ref.seed() for _ in range(3)]
    sec_o, sec_r = prng.SecretRandomGenerator(5), RefSec(5)
    assert np.array_equal(sec_o.random_binary(300), sec_r.random_binary(300))
    enc_o = prng.EncryptionRandomGenerator(11, prng.Seeder(3))
    enc_r = RefEnc(11, RefSeeder(3))
    for bits in (64, 32):
        assert np.array_equal(enc_o.random_mask(50, bits=bits),
                              enc_r.random_mask(50, bits=bits))
        assert np.array_equal(enc_o.random_noise(33, 3.2e-7, bits=bits),
                              enc_r.random_noise(33, 3.2e-7, bits=bits))
    kids_o = enc_o.fork_bsk_to_ggsw(2, 1, 2, 64)
    kids_r = enc_r.fork_bsk_to_ggsw(2, 1, 2, 64)
    for k_o, k_r in zip(kids_o, kids_r):
        assert np.array_equal(k_o.random_noise(64, 1e-5),
                              k_r.random_noise(64, 1e-5))
