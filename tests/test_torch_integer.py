"""The port's radix integers (tfhe_tpu_torch.integer, on the CPU) ==
tfhe_tpu.integer's host path, word for word, at
PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST with 4 blocks (8-bit integers): the
add, sub, mul, bitwise, trivial, overflowing, division and sum cases of
tests/test_integer.py (its scalar, comparison, selection and shift cases
are in test_torch_integer_ops.py).  Each op's output blocks must equal the
reference's (tolerance 0), with their degrees and noise levels, and
decrypt to the clear result (torch_integer_pair.py)."""

import pytest

from tfhe_tpu import integer as ref_integer
from tfhe_tpu.params import PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST as REF_P

from tfhe_tpu_torch import integer
from tfhe_tpu_torch.params import PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST as P
from torch_integer_pair import Pair, host_path_one_thread  # noqa: F401

NB = 4  # 8-bit integers
MOD = 4 ** NB
SEED = 11


@pytest.fixture(scope="module")
def keys():
    return Pair(ref_integer.gen_keys_radix(REF_P, NB, seed=SEED),
                integer.gen_keys_radix(P, NB, seed=SEED, device="cpu"))


CASES = [(0, 0), (1, 1), (255, 255), (200, 100), (37, 219), (128, 128),
         (3, 250)]


@pytest.mark.parametrize("a,b", CASES)
def test_add_sub(keys, a, b):
    ca, cb = keys.enc(a), keys.enc(b)
    assert keys.dec(keys.op("add_parallelized", ca, cb)) == (a + b) % MOD
    assert keys.dec(keys.op("sub_parallelized", ca, cb)) == (a - b) % MOD


@pytest.mark.parametrize("a,b", [(0, 0), (255, 255), (37, 219), (13, 17)])
def test_mul(keys, a, b):
    ca, cb = keys.enc(a), keys.enc(b)
    assert keys.dec(keys.op("mul_parallelized", ca, cb)) == (a * b) % MOD


def test_bitwise(keys):
    a, b = 0b10110101, 0b11001010
    ca, cb = keys.enc(a), keys.enc(b)
    assert keys.dec(keys.op("bitand_parallelized", ca, cb)) == a & b
    assert keys.dec(keys.op("bitor_parallelized", ca, cb)) == a | b
    assert keys.dec(keys.op("bitxor_parallelized", ca, cb)) == a ^ b
    assert keys.dec(keys.op("bitnot", ca)) == (~a) % MOD


def test_trivial_radix(keys):
    t = keys.op("create_trivial_radix", 123, NB)
    assert keys.dec(t) == 123
    assert keys.dec(keys.op("add_parallelized", t, keys.enc(10))) == 133


@pytest.mark.slow
def test_div_rem(keys):
    """Shift-subtract division with the reference's division by zero
    (ref: radix_parallel/div_mod.rs)."""
    for x, y in ((200, 7), (45, 45), (3, 200), (77, 0)):
        q, r = zip(*keys.op("div_rem_parallelized", keys.enc(x),
                            keys.enc(y)))
        assert keys.dec(q) == (x // y if y else MOD - 1)
        assert keys.dec(r) == (x % y if y else x)


def test_overflowing_ops(keys):
    for name, a, b, want, ovf in (
            ("overflowing_add_parallelized", 200, 100, 300 % MOD, True),
            ("overflowing_add_parallelized", 2, 3, 5, False),
            ("overflowing_sub_parallelized", 5, 9, (5 - 9) % MOD, True)):
        s, o = zip(*keys.op(name, keys.enc(a), keys.enc(b)))
        assert keys.dec(s) == want
        assert keys.dec(o, "decrypt_bool") is ovf


def test_sum_ciphertexts(keys):
    vals = [10, 20, 30, 40, 55, 17, 3]
    cts = [keys.enc(v) for v in vals]
    tot = keys.op("sum_ciphertexts_parallelized",
                  tuple(list(side) for side in zip(*cts)))
    assert keys.dec(tot) == sum(vals) % MOD
