"""The port's shortint ServerKey beyond one LUT (tfhe_tpu_torch.shortint, on
the CPU) == tfhe_tpu.shortint, word for word, at
PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST: every batch primitive (scalar add,
scalar mul, neg and sub with their correcting terms, add, the message and
carry extracts, trivial ciphertexts), one PBS over many LUTs with an
accumulator per element, every op family over all 16 clean pairs (the
unary ones over the 4 clean values) through the one-block API, the `_clean`
path at saturated carries, and `checked_add` raising `CheckError`.  Keys
and ciphertexts come from the same seed in both packages, encrypted in the
same order, so both start from the same words.  Cases of
tests/test_shortint.py and tests/test_shortint_sweep.py."""

import functools

import numpy as np
import pytest
import torch

from tfhe_tpu import shortint as ref_shortint
from tfhe_tpu.params import PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST as REF_PARAMS

from tfhe_tpu_torch import shortint
from tfhe_tpu_torch.ops.torus import to_numpy
from tfhe_tpu_torch.params import PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST as PARAMS

SEED = 77
MSG = PARAMS.message_modulus
VALUES = np.arange(PARAMS.total_modulus)  # every message + carry value
LHS, RHS = np.divmod(np.arange(MSG * MSG), MSG)  # the 16 clean pairs

BIVARIATE = {
    "mul_lsb": lambda x, y: (x * y) % MSG,
    "mul_msb": lambda x, y: (x * y) // MSG,
    "div": lambda x, y: (x // y) % MSG if y else MSG - 1,
    "mod_": lambda x, y: (x % y) % MSG if y else x % MSG,
    "bitand": lambda x, y: x & y,
    "bitor": lambda x, y: x | y,
    "bitxor": lambda x, y: x ^ y,
    "eq": lambda x, y: int(x == y),
    "ne": lambda x, y: int(x != y),
    "lt": lambda x, y: int(x < y),
    "le": lambda x, y: int(x <= y),
    "gt": lambda x, y: int(x > y),
    "ge": lambda x, y: int(x >= y),
    "add": lambda x, y: (x + y) % MSG,
    "sub": lambda x, y: (x - y) % MSG,
}
UNARY = {
    "neg": (lambda s, a: s.neg(a), lambda x: (-x) % MSG),
    "scalar_left_shift": (lambda s, a: s.scalar_left_shift(a, 1),
                          lambda x: (x << 1) % MSG),
    "scalar_right_shift": (lambda s, a: s.scalar_right_shift(a, 1),
                           lambda x: x >> 1),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run thousands of small tensor ops; one thread
    each keeps them fast when several test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.cache
def _keys():
    """Both packages' keys and, encrypted in the same order by both client
    keys, every value, the pairs' two sides and the clean values one block
    at a time."""
    out = []
    for pkg, params, kw in ((ref_shortint, REF_PARAMS, {}),
                            (shortint, PARAMS, {"device": "cpu"})):
        cks, sks = pkg.gen_keys(params, seed=SEED, **kw)
        values = cks.encrypt_batch(VALUES)
        lhs, rhs = cks.encrypt_batch(LHS), cks.encrypt_batch(RHS)
        blocks = [cks.encrypt(int(v)) for v in range(MSG)]
        out.append((cks, sks, values, lhs, rhs, blocks))
    return out


def _same(port_data, ref_data) -> bool:
    return np.array_equal(to_numpy(port_data), np.asarray(ref_data))


def _same_batch(got, want) -> bool:
    return (_same(got.data, want.data)
            and np.array_equal(got.degrees, want.degrees)
            and np.array_equal(got.noise, want.noise))


def _same_block(got, want) -> bool:
    return (_same(got.data, want.data) and got.degree == want.degree
            and got.noise_level == want.noise_level
            and got.is_trivial == want.is_trivial)


def test_key_constants_and_ciphertext_helpers():
    (_, rsk, _, _, _, rblocks), (_, psk, values, _, _, blocks) = _keys()
    assert (psk.max_noise_level, psk.delta, psk.max_degree) == (
        rsk.max_noise_level, rsk.delta, rsk.max_degree)
    ct = blocks[3]
    dup = ct.copy()
    assert dup.data is not ct.data and torch.equal(dup.data, ct.data)
    assert dup.total_modulus == rblocks[3].total_modulus == 16
    assert ct.carry_is_empty() and not shortint.Ciphertext(
        ct.data, MSG, MSG, MSG).carry_is_empty()
    both = values.copy()
    both.data[0, 0] += 1
    both.degrees[0] += 1
    assert not torch.equal(both.data, values.data)
    assert both.degrees[0] != values.degrees[0]


BATCH_PRIMITIVES = {
    "scalar_add": lambda s, v, a, b: s.unchecked_scalar_add_batch(
        v, np.arange(len(v)) % 7 - 3),
    "scalar_mul": lambda s, v, a, b: s.unchecked_scalar_mul_batch(v, 3),
    "neg": lambda s, v, a, b: s.unchecked_neg_batch(v),
    "sub": lambda s, v, a, b: s.unchecked_sub_batch(a, b),
    "add": lambda s, v, a, b: s.unchecked_add_batch(a, b),
    "message_extract": lambda s, v, a, b: s.message_extract_batch(v),
    "carry_extract": lambda s, v, a, b: s.carry_extract_batch(v),
    "trivial": lambda s, v, a, b: s.trivial_batch(VALUES * 5, len(VALUES)),
}


@pytest.mark.parametrize("name", sorted(BATCH_PRIMITIVES))
def test_batch_primitive_matches_reference(name):
    (rc, rsk, rvals, rl, rr, _), (pc, psk, pvals, pl, pr, _) = _keys()
    fn = BATCH_PRIMITIVES[name]
    want, got = fn(rsk, rvals, rl, rr), fn(psk, pvals, pl, pr)
    if name in ("neg", "sub"):
        (want, want_z), (got, got_z) = want, got
        assert np.array_equal(got_z, want_z)
    assert _same_batch(got, want)
    clear = {"scalar_add": (VALUES + np.arange(16) % 7 - 3) % 16,
             "scalar_mul": VALUES * 3 % 16,
             "neg": (got.degrees - VALUES) % 16,
             "sub": (LHS - RHS) % MSG,
             "add": (LHS + RHS) % 16,
             "message_extract": VALUES % MSG,
             "carry_extract": VALUES // MSG,
             "trivial": VALUES * 5 % 16}[name]
    dec = (pc.decrypt_batch(got) if name == "sub"
           else pc.decrypt_batch_message_and_carry(got))
    assert np.array_equal(dec, clear)


def test_trivial_batch_of_none_and_one():
    (_, rsk, *_), (_, psk, *_) = _keys()
    empty = psk.trivial_batch(np.zeros(0, np.uint64), 0)
    assert tuple(empty.data.shape) == (0, PARAMS.ciphertext_lwe_size)
    assert _same_block(psk.create_trivial(19), rsk.create_trivial(19))


def test_many_luts_in_one_batch_match_reference():
    (rc, rsk, _, rl, rr, _), (pc, psk, _, pl, pr, _) = _keys()
    names = sorted(BIVARIATE)
    pairs = np.arange(2 * len(LHS)) % len(LHS)
    selector = np.arange(len(pairs)) % len(names)
    outs = []
    for sks, lhs, rhs in ((rsk, rl, rr), (psk, pl, pr)):
        luts = [sks.generate_lookup_table_bivariate(BIVARIATE[k]).acc
                for k in names]
        packed = sks.unchecked_add_batch(
            sks.unchecked_scalar_mul_batch(_take(lhs, pairs), MSG),
            _take(rhs, pairs))
        outs.append(sks.apply_many_lookup_tables_batch(packed, luts,
                                                       selector))
    want, got = outs
    assert _same_batch(got, want)
    clear = [BIVARIATE[names[s]](LHS[i], RHS[i])
             for i, s in zip(pairs, selector)]
    assert np.array_equal(pc.decrypt_batch(got), clear)


def _take(batch, rows):
    data = batch.data[torch.as_tensor(rows)] if isinstance(
        batch.data, torch.Tensor) else batch.data[rows]
    return type(batch)(data, batch.degrees[rows], batch.message_modulus,
                       batch.carry_modulus, batch.noise[rows])


@pytest.mark.parametrize("family", sorted(BIVARIATE))
def test_op_family_matches_reference(family):
    (rc, rsk, *_, rblocks), (pc, psk, *_, blocks) = _keys()
    for x, y in zip(LHS, RHS):
        want = getattr(rsk, family)(rblocks[x], rblocks[y])
        got = getattr(psk, family)(blocks[x], blocks[y])
        assert _same_block(got, want), (family, x, y)
        assert pc.decrypt(got) == BIVARIATE[family](x, y), (family, x, y)


@pytest.mark.parametrize("family", sorted(UNARY))
def test_unary_op_family_matches_reference(family):
    (rc, rsk, *_, rblocks), (pc, psk, *_, blocks) = _keys()
    op, clear = UNARY[family]
    for x in range(MSG):
        want, got = op(rsk, rblocks[x]), op(psk, blocks[x])
        assert _same_block(got, want), (family, x)
        assert pc.decrypt(got) == clear(x), (family, x)


def _saturated(sks, blocks):
    """Degree 12 and degree 6 blocks (3+3, then doubled) holding 12 and 6."""
    six = sks.unchecked_add(blocks[3], blocks[3])
    return sks.unchecked_add(six, six), six


@pytest.mark.parametrize("op", ["add", "sub"])
def test_clean_path_at_saturated_carries(op):
    (rc, rsk, *_, rblocks), (pc, psk, *_, blocks) = _keys()
    r12, r6 = _saturated(rsk, rblocks)
    p12, p6 = _saturated(psk, blocks)
    assert p12.degree == 12 and not psk.is_add_possible(p12, p6)
    assert pc.decrypt_message_and_carry(p12) == 12
    want, got = getattr(rsk, op)(r12, r6), getattr(psk, op)(p12, p6)
    assert _same_block(got, want)
    assert pc.decrypt(got) == (12 + 6 if op == "add" else 12 - 6) % MSG
    # _clean keeps a clean block and refreshes a saturated one
    assert psk._clean(blocks[2]) is blocks[2]
    assert _same_block(psk._clean(p12), rsk._clean(r12))
    assert pc.decrypt_message_and_carry(psk._clean(p12)) == 12 % MSG


def test_checked_add_raises_on_overflow():
    (rc, rsk, *_, rblocks), (pc, psk, *_, blocks) = _keys()
    p12, p6 = _saturated(psk, blocks)
    r12, r6 = _saturated(rsk, rblocks)
    with pytest.raises(shortint.CheckError):
        psk.checked_add(p12, p6)  # 12 + 6 > 15
    with pytest.raises(ref_shortint.CheckError):
        rsk.checked_add(r12, r6)
    ok = psk.checked_add(p6, p6)
    assert _same_block(ok, rsk.checked_add(r6, r6))
    assert pc.decrypt_message_and_carry(ok) == 12
