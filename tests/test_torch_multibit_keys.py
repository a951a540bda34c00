"""The port's multi-bit parameters, PRNG forks and bootstrap keys ==
tfhe_tpu's, field for field and byte for byte from one seed."""

import dataclasses

import numpy as np
import pytest

from tfhe_tpu import core as ref_core
from tfhe_tpu import params as ref_params
from tfhe_tpu.params import multi_bit_params as ref_multi_bit_params
from tfhe_tpu.core.multibit import combine_key_bits as ref_combine_key_bits
from tfhe_tpu.prng import Seeder as RefSeeder
from tfhe_tpu.prng.generators import EncryptionRandomGenerator as RefEnc
from tfhe_tpu.prng.generators import SecretRandomGenerator as RefSec

from tfhe_tpu_torch import core, params, prng
from tfhe_tpu_torch.ops.torus import to_numpy

MULTI_BIT_SETS = [p.name for p in params.multi_bit_params.ALL] + [
    "PARAM_MULTI_BIT_MESSAGE_2_CARRY_2_GROUP_2_TEST"]


@pytest.mark.parametrize("name", MULTI_BIT_SETS)
def test_multi_bit_parameters_match_reference(name):
    p = getattr(params, name)
    ref = getattr(ref_multi_bit_params, name, None) or getattr(ref_params,
                                                                name)
    assert isinstance(p, params.MultiBitPBSParameters)
    assert [f.name for f in dataclasses.fields(p)] == [
        f.name for f in dataclasses.fields(ref)]
    for field in dataclasses.fields(p):
        a, b = getattr(p, field.name), getattr(ref, field.name)
        if field.name == "encryption_key_choice":
            a, b = a.value, b.value
        assert a == b, (name, field.name)
    for prop in ("glwe_size", "big_lwe_dimension", "total_modulus", "delta",
                 "max_degree", "max_noise_level"):
        assert getattr(p, prop) == getattr(ref, prop), (name, prop)
    assert p.pbs_order.value == ref.pbs_order.value
    assert p.ciphertext_lwe_size == p.big_lwe_dimension + 1


@pytest.mark.parametrize("gf", [2, 3])
def test_multi_bit_forks_match_reference(gf):
    ours = prng.EncryptionRandomGenerator(21, prng.Seeder(4))
    ref = RefEnc(21, RefSeeder(4))
    n, L, G, N = 2 * gf, 2, 2, 32
    groups_o = ours.fork_multi_bit_bsk_to_ggsw_group(n, L, G, N, gf)
    groups_r = ref.fork_multi_bit_bsk_to_ggsw_group(n, L, G, N, gf)
    assert len(groups_o) == len(groups_r) == 2
    for g_o, g_r in zip(groups_o, groups_r):
        kids_o = g_o.fork_multi_bit_bsk_ggsw_group_to_ggsw(L, G, N, gf)
        kids_r = g_r.fork_multi_bit_bsk_ggsw_group_to_ggsw(L, G, N, gf)
        assert len(kids_o) == len(kids_r) == 1 << gf
        for k_o, k_r in zip(kids_o, kids_r):
            assert np.array_equal(k_o.random_mask(N), k_r.random_mask(N))
            assert np.array_equal(k_o.random_noise(N, 1e-5),
                                  k_r.random_noise(N, 1e-5))
    # the parent streams continue past the forked budget identically
    assert np.array_equal(ours.random_mask(7), ref.random_mask(7))


@pytest.mark.parametrize("gf", [1, 2, 3, 4])
def test_combine_key_bits_every_pattern(gf):
    for pattern in range(1 << gf):
        # key bit i is bit gf-1-i of the pattern (MSB-first)
        bits = [(pattern >> (gf - 1 - i)) & 1 for i in range(gf)]
        for selector in range(1 << gf):
            got = core.combine_key_bits(selector, bits)
            assert got == ref_combine_key_bits(selector, np.array(bits))
            assert got == int(selector == pattern)


@pytest.mark.parametrize("shape", [
    dict(n=16, N=256, L=1, bl=23, gf=2),   # PARAM_..._GROUP_2_TEST's shape
    dict(n=6, N=256, L=2, bl=8, gf=3),
], ids=["gf2_test_set", "gf3_two_levels"])
def test_multi_bit_bsk_matches_reference(shape):
    n, N, L, bl, gf = (shape[k] for k in ("n", "N", "L", "bl", "gf"))
    std = 2.9403601535432533e-16
    sec_o, sec_r = prng.SecretRandomGenerator(17), RefSec(17)
    lwe_o = core.generate_binary_lwe_secret_key(n, sec_o, device="cpu")
    glwe_o = core.generate_binary_glwe_secret_key(1, N, sec_o, device="cpu")
    lwe_r = ref_core.generate_binary_lwe_secret_key(n, sec_r)
    glwe_r = ref_core.generate_binary_glwe_secret_key(1, N, sec_r)
    got = core.generate_multi_bit_bootstrap_key(
        lwe_o, glwe_o, bl, L, std, gf,
        prng.EncryptionRandomGenerator(8, prng.Seeder(9)))
    want = ref_core.generate_multi_bit_bootstrap_key(
        lwe_r, glwe_r, bl, L, std, gf, RefEnc(8, RefSeeder(9)))
    assert tuple(got.shape) == (n // gf, 1 << gf, L, 2, 2, N)
    assert np.array_equal(to_numpy(got), want)


def test_multi_bit_bsk_rejects_an_uneven_grouping():
    sec = prng.SecretRandomGenerator(1)
    lwe = core.generate_binary_lwe_secret_key(5, sec, device="cpu")
    glwe = core.generate_binary_glwe_secret_key(1, 16, sec, device="cpu")
    with pytest.raises(ValueError):
        core.generate_multi_bit_bootstrap_key(
            lwe, glwe, 8, 1, 1e-10, 2,
            prng.EncryptionRandomGenerator(1, prng.Seeder(1)))
