"""The high-level API, the examples and the multi-bit CRT-NTT layout on a
card == the port on the CPU, word for word: API keys from one seed at
PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST on both devices (the card's in the
host and in the single-program radix schedule), FheUint8 / FheInt8 /
FheBool operators and cast_into; a multi-bit mode="ntt" blind rotation at
PARAM_MULTI_BIT_MESSAGE_2_CARRY_2_GROUP_2_TEST; a SHA-256 adder and a
Trivium wave at BOOLEAN_SHA_TEST_PARAMETERS.  Marked `cuda`: it skips
where there is no card; on one, run `python -m pytest -m cuda --noconftest
tests/test_torch_api_cuda.py` (tests/conftest.py imports JAX, which is
not needed here)."""

import numpy as np
import pytest
import torch

from tfhe_tpu_torch import api, boolean, core, shortint
from tfhe_tpu_torch.apps import trivium as tv
from tfhe_tpu_torch.examples import sha256_bool as sb
from tfhe_tpu_torch.params import (
    BOOLEAN_SHA_TEST_PARAMETERS, PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST,
    PARAM_MULTI_BIT_MESSAGE_2_CARRY_2_GROUP_2_TEST)

pytestmark = pytest.mark.cuda

SEED = 2024
OPS = {  # name: (the operator, the clear result)
    "add": (lambda a, b, c: a + b, (201 + 77) % 256),
    "mul": (lambda a, b, c: a * b, 201 * 77 % 256),
    "lt": (lambda a, b, c: a < b, False),
    "select": (lambda a, b, c: c.if_then_else(a, b), 201),
    "xor_scalar_shift": (lambda a, b, c: (a ^ b) << 1, ((201 ^ 77) << 1) % 256),
    "cast_signed": (lambda a, b, c: a.cast_into(api.FheInt8), 201 - 256),
    "signed_abs": (lambda a, b, c: a.cast_into(api.FheInt8).abs(), 55),
}


@pytest.fixture(scope="module")
def keys():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    config = api.ConfigBuilder.default().use_custom_parameters(
        PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST).build()
    out = {}
    for where, fused in (("cuda", False), ("cuda", True), ("cpu", False)):
        out[where, fused] = api.generate_keys(config, seed=SEED, device=where,
                                              fused=fused)
    return out


def _inputs(cks):
    return (api.FheUint8.encrypt(201, cks), api.FheUint8.encrypt(77, cks),
            api.FheBool.encrypt(True, cks))


def _words(x):
    inner = x.inner
    b = inner.blocks if hasattr(inner, "blocks") else inner.block
    return b.data.cpu()


@pytest.mark.parametrize("op", sorted(OPS))
def test_api_ops_on_the_card_equal_the_cpu(keys, op):
    fn, want = OPS[op]
    outs = {}
    for k, (cks, sks) in keys.items():
        api.set_server_key(sks)
        outs[k] = fn(*_inputs(cks))
    cpu = outs["cpu", False]
    for k in (("cuda", False), ("cuda", True)):
        assert torch.equal(_words(outs[k]), _words(cpu)), k
        assert outs[k].decrypt(keys[k][0]) == want


def test_multi_bit_ntt_rotation_on_the_card_equals_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = PARAM_MULTI_BIT_MESSAGE_2_CARRY_2_GROUP_2_TEST
    rng = np.random.default_rng(3)
    lwe = rng.integers(0, 1 << 63, (8, p.lwe_dimension + 1), dtype=np.int64)
    lut = rng.integers(0, 1 << 63, (8, p.glwe_size, p.polynomial_size),
                       dtype=np.int64)
    _, sks = shortint.gen_keys(p, seed=SEED, device="cpu", mode="ntt")
    got = {}
    for where in ("cuda", "cpu"):
        key = core.prepare_multi_bit_bsk(sks.raw_bsk.to(where),
                                         p.pbs_base_log, p.grouping_factor,
                                         "ntt")
        got[where] = core.multi_bit_blind_rotate(
            key, torch.from_numpy(lut).to(where),
            torch.from_numpy(lwe).to(where)).cpu()
    scan3 = core.prepare_multi_bit_bsk(sks.raw_bsk.to("cuda"), p.pbs_base_log,
                                       p.grouping_factor, "scan3")
    kernels = core.multi_bit_blind_rotate(
        scan3, torch.from_numpy(lut).cuda(), torch.from_numpy(lwe).cuda())
    assert torch.equal(got["cuda"], got["cpu"])
    assert torch.equal(kernels.cpu(), got["cpu"])


class OneWaveTrivium(tv.TriviumStream):
    WARMUP_WAVES = 1


def test_sha256_adder_and_trivium_wave_on_the_card_equal_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    outs = {}
    for where in ("cuda", "cpu"):
        cks, sks = boolean.gen_keys(BOOLEAN_SHA_TEST_PARAMETERS, seed=SEED,
                                    device=where)
        eng = sb.Sha256Fhe(sks)
        a = cks.encrypt_batch(sb._word_bits_lsb(0xDEADBEEF))
        total = eng.add_many([a, eng.trivial_word(0x12345678), a])
        assert sb.decrypt_word(cks, total) == \
            (2 * 0xDEADBEEF + 0x12345678) % 2 ** 32
        key, iv = [1, 0] * 40, [0, 1] * 40
        stream = OneWaveTrivium(
            tv.FheBits(sks), cks.encrypt_batch(np.asarray(key, dtype=bool)),
            iv)
        z = stream.next_64()
        clear = OneWaveTrivium(tv.ClearBits(), tv.ClearBits().const(key),
                               iv).next_64().numpy()
        assert np.array_equal(cks.decrypt_batch(z), clear)
        outs[where] = (total.cpu(), z.cpu())
    for got, want in zip(outs["cuda"], outs["cpu"]):
        assert torch.equal(got, want)
