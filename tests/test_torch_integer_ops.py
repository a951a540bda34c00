"""The port's radix integers (tfhe_tpu_torch.integer, on the CPU) ==
tfhe_tpu.integer's host path, word for word, at
PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST with 4 blocks (8-bit integers): the
neg and scalar, comparison, selection and shift cases of
tests/test_integer.py (the arithmetic ones are in test_torch_integer.py).
Each op's output blocks must equal the reference's (tolerance 0), with
their degrees and noise levels, and decrypt to the clear result
(torch_integer_pair.py)."""

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


def test_neg_and_scalar_ops(keys):
    a = 37
    ca = keys.enc(a)
    assert keys.dec(keys.op("neg_parallelized", ca)) == (-a) % MOD
    assert keys.dec(keys.op("scalar_add_parallelized", ca, 100)) == \
        (a + 100) % MOD
    assert keys.dec(keys.op("scalar_sub_parallelized", ca, 50)) == \
        (a - 50) % MOD
    for s in (0, 1, 7, 255):
        assert keys.dec(keys.op("scalar_mul_parallelized", ca, s)) == \
            (a * s) % MOD


def test_comparisons(keys):
    a, b = 37, 219
    ca, cb = keys.enc(a), keys.enc(b)
    ca2 = keys.enc(a)
    for name, x, y, want in (("eq", ca, cb, False), ("eq", ca, ca2, True),
                             ("ne", ca, cb, True), ("lt", ca, cb, True),
                             ("le", ca, ca, True), ("gt", cb, ca, True),
                             ("ge", ca, cb, False)):
        got = keys.dec(keys.op(f"{name}_parallelized", x, y), "decrypt_bool")
        assert got is want, name
    assert keys.dec(keys.op("scalar_eq_parallelized", ca, a),
                    "decrypt_bool") is True
    assert keys.dec(keys.op("scalar_cmp_parallelized", ca, 100, "lt"),
                    "decrypt_bool") is True


def test_cmux_max_min(keys):
    a, b = 37, 219
    ca, cb = keys.enc(a), keys.enc(b)
    for cond, want in ((True, a), (False, b)):
        c = keys.enc_bool(cond)
        assert keys.dec(keys.op("if_then_else_parallelized", c, ca, cb)) \
            == want
    assert keys.dec(keys.op("max_parallelized", ca, cb)) == max(a, b)
    assert keys.dec(keys.op("min_parallelized", ca, cb)) == min(a, b)


def test_shifts_rotates(keys):
    """Wrapping shift semantics: the amount taken mod the bit width."""
    a = 0b10110101
    ca = keys.enc(a)
    for sh in (0, 1, 3, 7):
        assert keys.dec(keys.op("scalar_left_shift_parallelized", ca, sh)) \
            == (a << sh) % MOD
        assert keys.dec(keys.op("scalar_right_shift_parallelized", ca, sh)) \
            == a >> sh
    for rot in (0, 1, 5):
        exp = ((a << rot) | (a >> (8 - rot))) % MOD if rot else a
        assert keys.dec(keys.op("scalar_rotate_left_parallelized", ca,
                                rot)) == exp
        exp_r = ((a >> rot) | (a << (8 - rot))) % MOD if rot else a
        assert keys.dec(keys.op("scalar_rotate_right_parallelized", ca,
                                rot)) == exp_r


def test_encrypted_amount_shifts(keys):
    a = 0b10110101
    ca = keys.enc(a)
    for s in (0, 2, 5):
        amt = keys.enc(s)
        assert keys.dec(keys.op("left_shift_parallelized", ca, amt)) == \
            (a << s) % MOD
        assert keys.dec(keys.op("right_shift_parallelized", ca, amt)) == \
            a >> s
        exp = ((a << s) | (a >> (8 - s))) % MOD if s else a
        assert keys.dec(keys.op("rotate_left_parallelized", ca, amt)) == exp


@pytest.mark.slow
def test_scalar_div_rem(keys):
    for d in (3, 7, 12, 255):
        assert keys.dec(keys.op("scalar_div_parallelized", keys.enc(201),
                                d)) == 201 // d
        assert keys.dec(keys.op("scalar_rem_parallelized", keys.enc(201),
                                d)) == 201 % d
