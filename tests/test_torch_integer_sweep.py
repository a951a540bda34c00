"""A seeded sweep of the port's radix ops (tfhe_tpu_torch.integer, on the
CPU) == tfhe_tpu.integer's host path, word for word, at
PARAM_MESSAGE_2_CARRY_2_TEST with 4 blocks (8-bit): six pairs of
tests/test_integer_sweep.py's generator through its unsigned op families,
and the sequential carry propagation (message modulus 2 < 4) at
PARAM_MESSAGE_1_CARRY_1_TEST.  Each op's output blocks must equal the
reference's (tolerance 0), with their degrees and noise levels, and decrypt
to the clear result (torch_integer_pair.py)."""

import random

import pytest

from tfhe_tpu import integer as ref_integer
from tfhe_tpu.params import PARAM_MESSAGE_1_CARRY_1_TEST as REF_P11
from tfhe_tpu.params import PARAM_MESSAGE_2_CARRY_2_TEST as REF_P

from tfhe_tpu_torch import integer
from tfhe_tpu_torch.params import PARAM_MESSAGE_1_CARRY_1_TEST as P11
from tfhe_tpu_torch.params import PARAM_MESSAGE_2_CARRY_2_TEST as P
from torch_integer_pair import Pair, host_path_one_thread  # noqa: F401

NB = 4  # 8-bit integers
MOD = 1 << 8

OPS = {
    "add_parallelized": lambda x, y: (x + y) % MOD,
    "sub_parallelized": lambda x, y: (x - y) % MOD,
    "mul_parallelized": lambda x, y: (x * y) % MOD,
    "bitand_parallelized": lambda x, y: x & y,
    "bitor_parallelized": lambda x, y: x | y,
    "bitxor_parallelized": lambda x, y: x ^ y,
    "max_parallelized": max,
    "min_parallelized": min,
}
rng = random.Random(7777)
PAIRS = [(rng.randrange(MOD), rng.randrange(MOD)) for _ in range(6)]
# each pair through two op families, every family twice
SWEEP = [(x, y, list(OPS)[(2 * i + k) % len(OPS)])
         for i, (x, y) in enumerate(PAIRS) for k in range(2)]


@pytest.fixture(scope="module")
def keys():
    return Pair(ref_integer.gen_keys_radix(REF_P, NB, seed=7777),
                integer.gen_keys_radix(P, NB, seed=7777, device="cpu"))


@pytest.mark.parametrize("x,y", PAIRS)
def test_unsigned_sweep(keys, x, y):
    for xx, yy, name in SWEEP:
        if (xx, yy) == (x, y):
            got = keys.dec(keys.op(name, keys.enc(x), keys.enc(y)))
            assert got == OPS[name](x, y), (name, x, y)


def test_aliasing_same_operand(keys):
    """x op x on one ciphertext object."""
    a = keys.enc(173)
    assert keys.dec(keys.op("add_parallelized", a, a)) == (2 * 173) % MOD
    assert keys.dec(keys.op("sub_parallelized", a, a)) == 0


def test_sequential_carry_propagation():
    # message modulus 2: propagate_single_carry takes the one-block-at-a-
    # time chain (radix/mod.rs's sequential path) instead of the prefix scan
    nb = 4  # 4-bit integers
    keys = Pair(ref_integer.gen_keys_radix(REF_P11, nb, seed=21),
                integer.gen_keys_radix(P11, nb, seed=21, device="cpu"))
    for a, b in ((9, 11), (15, 1)):
        ca, cb = keys.enc(a), keys.enc(b)
        assert keys.dec(keys.op("add_parallelized", ca, cb)) == (a + b) % 16
    s, o = zip(*keys.op("overflowing_add_parallelized", keys.enc(15),
                        keys.enc(3)))
    assert keys.dec(s) == 2 and keys.dec(o, "decrypt_bool") is True
