"""The port's signed radix and CRT integers (tfhe_tpu_torch.integer, on the
CPU) == tfhe_tpu.integer's host path, word for word: the cases of
tests/test_signed.py (PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST, 4 blocks, two's
complement 8-bit, seed 13) and tests/test_crt.py (PARAM_MESSAGE_2_CARRY_2_
TEST, basis [2, 3], seed 999).  Signed add, sub and lt, abs, an arithmetic
right shift and CRT add, mul and neg run in tier-1; the rest is marked
`slow`, as the reference's files are.  Each op's output blocks must equal
the reference's (tolerance 0), with their degrees and noise levels, and
decrypt to the clear result (torch_integer_pair.py).  The reference's
`test_crt_serialization` waits for the port's serialization."""

import pytest

from tfhe_tpu import integer as ref_integer
from tfhe_tpu.params import PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST as REF_P
from tfhe_tpu.params import PARAM_MESSAGE_2_CARRY_2_TEST as REF_P_CRT

from tfhe_tpu_torch import integer
from tfhe_tpu_torch.params import PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST as P
from tfhe_tpu_torch.params import PARAM_MESSAGE_2_CARRY_2_TEST as P_CRT
from torch_integer_pair import Pair, host_path_one_thread  # noqa: F401

NB = 4  # 8-bit signed integers
MOD = 1 << 8
BASIS = [2, 3]


def wrap(v):
    v %= MOD
    return v - MOD if v >= MOD // 2 else v


@pytest.fixture(scope="module")
def keys():
    return Pair(ref_integer.gen_keys_radix(REF_P, NB, seed=13),
                integer.gen_keys_radix(P, NB, seed=13, device="cpu"))


@pytest.fixture(scope="module")
def crt_keys():
    return Pair(ref_integer.gen_keys_crt(REF_P_CRT, BASIS, seed=999),
                integer.gen_keys_crt(P_CRT, BASIS, seed=999, device="cpu"))


CASES = [(0, 0), (-1, 1), (-128, 127), (57, -33), (-100, -28), (127, 127)]


@pytest.mark.parametrize("a,b", CASES[1:4])
def test_signed_add_sub_lt(keys, a, b):
    ca, cb = keys.enc(a, signed=True), keys.enc(b, signed=True)
    assert keys.dec(keys.op("add_parallelized", ca, cb),
                    "decrypt_signed") == wrap(a + b)
    assert keys.dec(keys.op("sub_parallelized", ca, cb),
                    "decrypt_signed") == wrap(a - b)
    assert keys.dec(keys.op("signed_cmp_parallelized", ca, cb, "lt"),
                    "decrypt_bool") is (a < b)


@pytest.mark.parametrize("a", [-128, -37, 90])
def test_abs(keys, a):
    ca = keys.enc(a, signed=True)
    assert keys.dec(keys.op("abs_parallelized", ca),
                    "decrypt_signed") == wrap(abs(a))


@pytest.mark.parametrize("a,shift", [(-100, 2), (57, 3)])
def test_arithmetic_right_shift_by_a_clear_amount(keys, a, shift):
    ca = keys.enc(a, signed=True)
    assert keys.dec(keys.op("signed_scalar_right_shift_parallelized", ca,
                            shift), "decrypt_signed") == (a >> shift)


@pytest.mark.slow
@pytest.mark.parametrize("a,b", CASES)
def test_signed_add_sub_mul(keys, a, b):
    ca, cb = keys.enc(a, signed=True), keys.enc(b, signed=True)
    for name, want in (("add_parallelized", a + b),
                       ("sub_parallelized", a - b),
                       ("mul_parallelized", a * b)):
        assert keys.dec(keys.op(name, ca, cb), "decrypt_signed") == \
            wrap(want), name


@pytest.mark.slow
@pytest.mark.parametrize("a,b", CASES)
def test_signed_comparisons(keys, a, b):
    ca, cb = keys.enc(a, signed=True), keys.enc(b, signed=True)
    for op, f in [("lt", a < b), ("le", a <= b), ("gt", a > b),
                  ("ge", a >= b), ("eq", a == b), ("ne", a != b)]:
        assert keys.dec(keys.op("signed_cmp_parallelized", ca, cb, op),
                        "decrypt_bool") is f, op
    assert keys.dec(keys.op("signed_scalar_cmp_parallelized", ca, b, "lt"),
                    "decrypt_bool") is (a < b)


@pytest.mark.slow
@pytest.mark.parametrize("a", [-128, -37, -1, 0, 1, 90, 127])
def test_abs_and_sign(keys, a):
    ca = keys.enc(a, signed=True)
    assert keys.dec(keys.op("abs_parallelized", ca),
                    "decrypt_signed") == wrap(abs(a))
    assert keys.dec(keys.op("sign_bit_parallelized", ca),
                    "decrypt_bool") is (a < 0)


@pytest.mark.slow
@pytest.mark.parametrize("a,shift", [(-100, 2), (-1, 5), (57, 3), (-128, 7)])
def test_arithmetic_right_shift(keys, a, shift):
    ca = keys.enc(a, signed=True)
    assert keys.dec(keys.op("signed_scalar_right_shift_parallelized", ca,
                            shift), "decrypt_signed") == (a >> shift)
    cs = keys.enc(shift)
    assert keys.dec(keys.op("signed_right_shift_parallelized", ca, cs),
                    "decrypt_signed") == (a >> shift)


@pytest.mark.slow
@pytest.mark.parametrize("a,b", [(7, 3), (-7, 3), (7, -3), (-7, -3),
                                 (-128, 3), (100, -7)])
def test_signed_div_rem(keys, a, b):
    ca, cb = keys.enc(a, signed=True), keys.enc(b, signed=True)
    want_q = int(a / b)  # truncation toward zero
    want_r = a - want_q * b
    q, r = zip(*keys.op("signed_div_rem_parallelized", ca, cb))
    assert keys.dec(q, "decrypt_signed") == want_q
    assert keys.dec(r, "decrypt_signed") == want_r
    q2, r2 = zip(*keys.op("signed_scalar_div_rem_parallelized", ca, b))
    assert keys.dec(q2, "decrypt_signed") == want_q
    assert keys.dec(r2, "decrypt_signed") == want_r


@pytest.mark.slow
@pytest.mark.parametrize("a,b,ovf_add,ovf_sub", [
    (100, 100, True, False), (-100, -100, True, False),
    (-100, 100, False, True), (100, -28, False, True),
    (-128, -1, True, False)])
def test_signed_overflowing(keys, a, b, ovf_add, ovf_sub):
    ca, cb = keys.enc(a, signed=True), keys.enc(b, signed=True)
    s, ov = zip(*keys.op("signed_overflowing_add_parallelized", ca, cb))
    assert keys.dec(s, "decrypt_signed") == wrap(a + b)
    assert keys.dec(ov, "decrypt_bool") is ovf_add
    d, ov2 = zip(*keys.op("signed_overflowing_sub_parallelized", ca, cb))
    assert keys.dec(d, "decrypt_signed") == wrap(a - b)
    assert keys.dec(ov2, "decrypt_bool") is ovf_sub


@pytest.mark.slow
def test_signed_min_max(keys):
    ca, cb = keys.enc(-5, signed=True), keys.enc(3, signed=True)
    assert keys.dec(keys.op("signed_max_parallelized", ca, cb),
                    "decrypt_signed") == 3
    assert keys.dec(keys.op("signed_min_parallelized", ca, cb),
                    "decrypt_signed") == -5


def test_i_crt():
    assert integer.i_crt([2, 3, 5], [0, 2, 3]) == 8
    assert integer.i_crt([2, 3, 5], [1, 1, 1]) == 1
    for x in range(30):
        assert integer.i_crt([2, 3, 5], [x % 2, x % 3, x % 5]) == x
        assert integer.i_crt([2, 3, 5], [x % 2, x % 3, x % 5]) == \
            ref_integer.i_crt([2, 3, 5], [x % 2, x % 3, x % 5])


def test_crt_add_mul_neg(crt_keys):
    for a, b in [(1, 5), (5, 5)]:
        ca, cb = crt_keys.enc(a), crt_keys.enc(b)
        assert crt_keys.dec(crt_keys.op("crt_add_parallelized", ca, cb)) == \
            (a + b) % 6
        assert crt_keys.dec(crt_keys.op("crt_mul_parallelized", ca, cb)) == \
            (a * b) % 6
        assert crt_keys.dec(crt_keys.op("crt_neg_parallelized", ca)) == \
            (-a) % 6


@pytest.mark.slow
def test_crt_encrypt_decrypt(crt_keys):
    for x in range(6):
        assert crt_keys.dec(crt_keys.enc(x)) == x


@pytest.mark.slow
def test_crt_add(crt_keys):
    for a, b in [(0, 0), (1, 5), (4, 3), (5, 5)]:
        ct = crt_keys.op("crt_add_parallelized", crt_keys.enc(a),
                         crt_keys.enc(b))
        assert crt_keys.dec(ct) == (a + b) % 6, (a, b)


@pytest.mark.slow
def test_crt_add_chain_triggers_extract(crt_keys):
    ct, total = crt_keys.enc(3), 3
    for v in [4, 5, 2, 1, 5]:
        ct = crt_keys.op("crt_add_parallelized", ct, crt_keys.enc(v))
        total += v
    assert crt_keys.dec(ct) == total % 6


@pytest.mark.slow
def test_crt_neg_sub(crt_keys):
    for a in range(6):
        assert crt_keys.dec(crt_keys.op("crt_neg_parallelized",
                                        crt_keys.enc(a))) == (-a) % 6
    for a, b in [(5, 2), (0, 4), (3, 3), (1, 5)]:
        ct = crt_keys.op("crt_sub_parallelized", crt_keys.enc(a),
                         crt_keys.enc(b))
        assert crt_keys.dec(ct) == (a - b) % 6, (a, b)


@pytest.mark.slow
def test_crt_mul(crt_keys):
    for a, b in [(0, 5), (2, 3), (5, 5), (4, 2), (3, 5)]:
        ct = crt_keys.op("crt_mul_parallelized", crt_keys.enc(a),
                         crt_keys.enc(b))
        assert crt_keys.dec(ct) == (a * b) % 6, (a, b)


@pytest.mark.slow
def test_crt_scalar_ops(crt_keys):
    for a, s in [(3, 4), (5, 7), (2, 0)]:
        for name, want in (("crt_scalar_add_parallelized", a + s),
                           ("crt_scalar_sub_parallelized", a - s),
                           ("crt_scalar_mul_parallelized", a * s)):
            assert crt_keys.dec(crt_keys.op(name, crt_keys.enc(a), s)) == \
                want % 6, name


@pytest.mark.slow
def test_crt_pbs_function(crt_keys):
    for a in range(6):
        ct = crt_keys.op("pbs_crt_compliant_function_parallelized",
                         crt_keys.enc(a), lambda x: x * x * x)
        assert crt_keys.dec(ct) == (a ** 3) % 6, a
