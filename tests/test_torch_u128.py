"""The port's 128-bit torus (tfhe_tpu_torch.ops.u128, core.u128_crypto and
the 128-bit blind rotation, on the CPU) == tfhe_tpu's, word for word: the
cases of tests/test_u128.py (pair arithmetic against Python integers, with
the carry edges; monomial products at every degree listed there; LWE and
GLWE round trips), then encryptions, the bootstrap key (n = 4, N = 64,
base_log 18, 2 levels) and the f128 PBS outputs from the same seeds as the
reference, the vectorised negacyclic product against the reference's
Python-integer one, and the key carried across by `weights.py`."""

import functools

import numpy as np
import pytest
import torch

from tfhe_tpu import core as ref_core
from tfhe_tpu.core import u128_crypto as ref_u128_crypto
from tfhe_tpu.ops.polymul_ntt import prepare_bsk_ntt as ref_prepare_bsk_ntt
from tfhe_tpu.prng.generators import (
    EncryptionRandomGenerator as RefEncGen, SecretRandomGenerator as RefSecGen)
from tfhe_tpu.prng.stream import Seeder as RefSeeder

from tfhe_tpu_torch import core, weights
from tfhe_tpu_torch.ops import u128
from tfhe_tpu_torch.prng import Seeder
from tfhe_tpu_torch.prng.generators import (EncryptionRandomGenerator,
                                            SecretRandomGenerator)

MOD = 1 << 128
# the toy f128 PBS of tests/test_u128.py
N_IN, K, N, BASE_LOG, LEVELS, MSUP = 4, 1, 64, 18, 2, 4
DELTA = MOD // (2 * MSUP)
STD = 2.0 ** -60
LUTS = (lambda x: x, lambda x: (3 * x + 1) % MSUP)


def _ints(t):
    return u128.np_unpack(u128.to_numpy(t))


def _edge_ints():
    """Python ints whose words sit at the unsigned-compare edges."""
    words = (0, 1, 2**63 - 1, 2**63, 2**63 + 1, 2**64 - 1)
    return [lo | (hi << 64) for lo in words for hi in words]


def test_pair_arithmetic_matches_python_ints():
    rng = np.random.default_rng(0)
    a_ints = [int.from_bytes(rng.bytes(16), "little") for _ in range(32)]
    b_ints = [int.from_bytes(rng.bytes(16), "little") for _ in range(32)]
    edges = _edge_ints()
    a_ints += [x for x in edges for _ in edges]
    b_ints += [y for _ in edges for y in edges]
    a = u128.to_tensor(u128.np_pack(a_ints), "cpu")
    b = u128.to_tensor(u128.np_pack(b_ints), "cpu")
    assert _ints(a) == [x % MOD for x in a_ints]
    assert _ints(u128.add(a, b)) == [(x + y) % MOD
                                     for x, y in zip(a_ints, b_ints)]
    assert _ints(u128.sub(a, b)) == [(x - y) % MOD
                                     for x, y in zip(a_ints, b_ints)]
    assert _ints(u128.neg(a)) == [(-x) % MOD for x in a_ints]
    for k in (0, 1, 31, 32, 63, 64, 95, 127):
        assert _ints(u128.shl(a, k)) == [(x << k) % MOD for x in a_ints]
    planes = u128.to_planes32(a[None])  # [1, 4, n]
    for m in range(4):
        assert planes[0, m].tolist() == [(x >> (32 * m)) & 0xFFFFFFFF
                                         for x in a_ints]
    signed = torch.tensor([[-(2**62), -1, 0, 5, 2**62 - 1]] * 3)
    want = [sum(v * 2**(32 * m) for m, v in enumerate(col)) % MOD
            for col in zip(*signed.tolist())]
    assert _ints(u128.from_signed_planes(signed)) == want


def test_carry_edges_of_the_low_word():
    # the carry of lo = alo + blo is an unsigned compare: check it where the
    # signed one would differ, at 0, 2^63 - 1, 2^63 and 2^64 - 1
    for x, y in ((2**64 - 1, 1), (2**63, 2**63), (2**63 - 1, 1),
                 (2**63 - 1, 2**63), (0, 2**64 - 1), (2**64 - 1, 2**64 - 1)):
        a = u128.to_tensor(u128.np_pack([x]), "cpu")
        b = u128.to_tensor(u128.np_pack([y]), "cpu")
        assert _ints(u128.add(a, b)) == [(x + y) % MOD]
        assert _ints(u128.sub(a, b)) == [(x - y) % MOD]
        assert _ints(u128.sub(b, a)) == [(y - x) % MOD]


def test_monomial_mul_matches_python_ints():
    n = 16
    rng = np.random.default_rng(1)
    poly_ints = [int.from_bytes(rng.bytes(16), "little") for _ in range(n)]
    poly = u128.to_tensor(u128.np_pack(poly_ints), "cpu")[None]  # [1, n, 2]
    for d in (0, 1, 5, n - 1, n, n + 3, 2 * n - 1, 2 * n):
        got = _ints(u128.monomial_mul(poly, torch.tensor([d]), n)[0])
        want = [0] * n
        for i, c in enumerate(poly_ints):
            j = (i + d) % (2 * n)
            if j < n:
                want[j] = (want[j] + c) % MOD
            else:
                want[j - n] = (want[j - n] - c) % MOD
        assert got == want, f"degree {d}"
        back = u128.monomial_div(u128.monomial_mul(poly, d, n), d, n)
        assert torch.equal(back, poly)


@pytest.mark.parametrize("n", [64, 256])
def test_negacyclic_product_matches_the_reference(n):
    rng = np.random.default_rng(n)
    mask_ints = [int.from_bytes(rng.bytes(16), "little") for _ in range(n)]
    mask_ints[:3] = [0, MOD - 1, 2**64 - 1]
    s_bits = rng.integers(0, 2, n).astype(np.uint64)
    want = ref_u128_crypto._negacyclic_mul_binary(mask_ints, s_bits, n)
    got = core.negacyclic_mul_binary(
        u128.to_tensor(u128.np_pack(mask_ints), "cpu"),
        torch.from_numpy(s_bits.astype(np.int64)))
    assert _ints(got) == want


def test_lwe_roundtrip_matches_the_reference():
    n, delta, msgs = 16, 1 << 120, [0, 1, 5, 255]
    ref_bits = RefSecGen(7).random_binary(n)
    ref_ct = ref_u128_crypto.encrypt_lwe_u128(
        ref_bits, [m * delta for m in msgs], 2.0 ** -40,
        RefEncGen(8, RefSeeder(8)))
    bits = core.generate_binary_lwe_secret_key_u128(
        n, SecretRandomGenerator(7), device="cpu")
    assert np.array_equal(bits.numpy(), ref_bits)
    ct = core.encrypt_lwe_u128(bits, [m * delta for m in msgs], 2.0 ** -40,
                               EncryptionRandomGenerator(8, Seeder(8)))
    assert ct.shape == (4, n + 1, 2)
    assert np.array_equal(u128.to_numpy(ct), ref_ct)
    phases = _ints(core.decrypt_lwe_u128(bits, ct))
    assert phases == ref_u128_crypto.decrypt_lwe_u128(ref_bits, ref_ct)
    assert [((ph + delta // 2) // delta) % 256 for ph in phases] == msgs


def test_glwe_roundtrip_matches_the_reference():
    k, n = 2, 32
    gbits = RefSecGen(9).random_binary(k * n).reshape(k, n)
    delta = 1 << 121
    vals = [(i % 5) * delta for i in range(n)]
    ref_ct = ref_u128_crypto.encrypt_glwe_preset_u128(
        gbits, vals, 2.0 ** -40, RefEncGen(10, RefSeeder(10)))
    bits = torch.from_numpy(gbits.astype(np.int64))
    ct = core.encrypt_glwe_preset_u128(
        bits, vals, 2.0 ** -40, EncryptionRandomGenerator(10, Seeder(10)))
    assert np.array_equal(u128.to_numpy(ct), ref_ct)
    phase = _ints(core.decrypt_glwe_u128(bits, ct))
    assert phase == ref_u128_crypto.decrypt_glwe_u128(gbits, ref_ct)
    for ph, want in zip(phase, vals):
        assert ((ph + delta // 2) // delta) * delta % MOD == want


@functools.cache
def _toy_keys():
    """The toy PBS's keys and ciphertexts in both packages, from the
    tests/test_u128.py seeds."""
    sec, enc = RefSecGen(11), RefEncGen(12, RefSeeder(12))
    r_lwe = sec.random_binary(N_IN)
    r_glwe = sec.random_binary(K * N).reshape(K, N)
    r_bsk = ref_u128_crypto.generate_bootstrap_key_u128(
        r_lwe, r_glwe, BASE_LOG, LEVELS, STD, enc)
    r_cts = ref_u128_crypto.encrypt_lwe_u128(
        r_lwe, [m * DELTA for m in range(MSUP)], STD, enc)

    sec, enc = SecretRandomGenerator(11), EncryptionRandomGenerator(
        12, Seeder(12))
    lwe = core.generate_binary_lwe_secret_key_u128(N_IN, sec, device="cpu")
    glwe = core.generate_binary_lwe_secret_key_u128(
        K * N, sec, device="cpu").reshape(K, N)
    bsk = core.generate_bootstrap_key_u128(lwe, glwe, BASE_LOG, LEVELS, STD,
                                           enc)
    cts = core.encrypt_lwe_u128(lwe, [m * DELTA for m in range(MSUP)], STD,
                                enc)
    return (r_glwe, r_bsk, r_cts), (glwe, bsk, cts)


def test_bootstrap_key_and_encryptions_match_the_reference():
    (r_glwe, r_bsk, r_cts), (glwe, bsk, cts) = _toy_keys()
    assert np.array_equal(glwe.numpy(), r_glwe)
    assert bsk.shape == (N_IN, LEVELS, K + 1, K + 1, N, 2)
    assert np.array_equal(u128.to_numpy(bsk), r_bsk)
    assert np.array_equal(u128.to_numpy(cts), r_cts)


@pytest.mark.parametrize("lut", [0, 1], ids=["identity", "3x_plus_1"])
def test_f128_pbs_matches_the_reference(lut):
    (r_glwe, r_bsk, r_cts), (glwe, bsk, cts) = _toy_keys()
    f = LUTS[lut]
    r_acc = ref_core.fill_accumulator_u128(f, N, K + 1, MSUP, DELTA)
    acc = core.fill_accumulator_u128(f, N, K + 1, MSUP, DELTA, device="cpu")
    assert np.array_equal(u128.to_numpy(acc), r_acc)
    want = np.asarray(ref_core.programmable_bootstrap(
        ref_prepare_bsk_ntt(r_bsk, BASE_LOG, bits=128), r_acc, r_cts))
    key = core.prepare_bsk_ntt(bsk, BASE_LOG, bits=128, device="cpu")
    got = core.programmable_bootstrap(key, acc, cts)
    assert got.shape == (MSUP, K * N + 1, 2)
    assert np.array_equal(u128.to_numpy(got), want)
    phases = _ints(core.decrypt_lwe_u128(glwe.reshape(-1), got))
    assert [((ph + DELTA // 2) // DELTA) % (2 * MSUP) for ph in phases] == [
        f(m) % MSUP for m in range(MSUP)]


def test_weights_carry_the_reference_key_across():
    (_, r_bsk, r_cts), (glwe, _, cts) = _toy_keys()
    key = weights.bootstrap_key_u128_from_reference(
        r_bsk, BASE_LOG, N_IN, K, N, LEVELS, device="cpu")
    assert isinstance(key, core.PreparedBskNtt) and key.bits == 128
    acc = core.fill_accumulator_u128(LUTS[1], N, K + 1, MSUP, DELTA,
                                     device="cpu")
    mine = core.prepare_bsk_ntt(_toy_keys()[1][1], BASE_LOG, bits=128,
                                device="cpu")
    assert torch.equal(key.spectra, mine.spectra)
    assert torch.equal(core.programmable_bootstrap(key, acc, cts),
                       core.programmable_bootstrap(mine, acc, cts))
    for bad in (r_bsk[1:], r_bsk[..., :1], r_bsk.astype(np.int64)):
        with pytest.raises(ValueError, match="u128 BSK"):
            weights.bootstrap_key_u128_from_reference(
                bad, BASE_LOG, N_IN, K, N, LEVELS, device="cpu")
