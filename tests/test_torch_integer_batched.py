"""The port's batched radix ops (tfhe_tpu_torch.integer.batched, on the
CPU) == tfhe_tpu.integer.batched, word for word (tolerance 0), at
PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST with 4 blocks: add, sub, neg and mul
in both carry schedules (the reference's TFHE_TPU_CARRY_MODE set to the
same schedule in the test), with the all-propagate carry chains of
tests/test_batched.py, and eq, ne, lt, le, gt, ge; every result decrypts
to the clear one and leaves its inputs unchanged.  An unknown schedule
raises in the port (the reference falls back to the scan)."""

import numpy as np
import pytest

from tfhe_tpu import integer as ref_integer
from tfhe_tpu.integer.batched import BatchedRadixOps as RefOps
from tfhe_tpu.integer.batched import encrypt_batch_radix as ref_encrypt
from tfhe_tpu.params import PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST as REF_P

from tfhe_tpu_torch import integer
from tfhe_tpu_torch.integer.batched import (BatchedRadixOps,
                                            decrypt_batch_radix,
                                            encrypt_batch_radix)
from tfhe_tpu_torch.ops.torus import to_numpy
from tfhe_tpu_torch.params import PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST as P
from torch_integer_pair import host_path_one_thread  # noqa: F401

NB = 4
MOD = 4 ** NB
SEED = 7
rng = np.random.default_rng(3)
AV = rng.integers(0, MOD, 4).tolist() + [MOD - 1, MOD - 1]
BV = rng.integers(0, MOD, 4).tolist() + [1, MOD - 1]  # carry chains


@pytest.fixture(scope="module")
def keys():
    rc, rk = ref_integer.gen_keys_radix(REF_P, NB, seed=SEED)
    pc, pk = integer.gen_keys_radix(P, NB, seed=SEED, device="cpu")
    return (rc, rk.key), (pc, pk.key)


def _pair(keys, av, bv):
    (rc, _), (pc, _) = keys
    ra, rb = ref_encrypt(rc, av, NB), ref_encrypt(rc, bv, NB)
    pa, pb = encrypt_batch_radix(pc, av, NB), encrypt_batch_radix(pc, bv, NB)
    assert np.array_equal(np.asarray(ra), to_numpy(pa))
    return (ra, rb), (pa, pb)


def _run(ref_ops, port_ops, name, ref_args, port_args):
    before = [a.clone() for a in port_args]
    got = getattr(port_ops, name)(*port_args)
    assert all(a.equal(b) for a, b in zip(port_args, before)), name
    want = getattr(ref_ops, name)(*ref_args)
    assert np.array_equal(np.asarray(want), to_numpy(got)), name
    return got


@pytest.mark.parametrize("mode", ["scan", "ripple"])
def test_add_sub_neg(keys, mode, monkeypatch):
    monkeypatch.setenv("TFHE_TPU_CARRY_MODE", mode)
    (rc, rsks), (pc, psks) = keys
    ref_ops, port_ops = RefOps(rsks), BatchedRadixOps(psks, mode)
    (ra, rb), (pa, pb) = _pair(keys, AV, BV)
    for name, f in (("add", lambda x, y: (x + y) % MOD),
                    ("sub", lambda x, y: (x - y) % MOD)):
        got = _run(ref_ops, port_ops, name, (ra, rb), (pa, pb))
        assert decrypt_batch_radix(pc, got) == [f(x, y)
                                                for x, y in zip(AV, BV)]
    got = _run(ref_ops, port_ops, "neg", (ra,), (pa,))
    assert decrypt_batch_radix(pc, got) == [-x % MOD for x in AV]


@pytest.mark.parametrize("mode", ["scan", "ripple"])
def test_mul(keys, mode, monkeypatch):
    monkeypatch.setenv("TFHE_TPU_CARRY_MODE", mode)
    (rc, rsks), (pc, psks) = keys
    av, bv = [7, 250, MOD - 1], [31, 9, MOD - 1]
    (ra, rb), (pa, pb) = _pair(keys, av, bv)
    got = _run(RefOps(rsks), BatchedRadixOps(psks, mode), "mul", (ra, rb),
               (pa, pb))
    assert decrypt_batch_radix(pc, got) == [x * y % MOD
                                            for x, y in zip(av, bv)]


def test_ripple_propagate(keys):
    """The ripple chain alone on sums of two clean blocks (its invariant)."""
    (rc, rsks), (pc, psks) = keys
    (ra, rb), (pa, pb) = _pair(keys, AV, BV)
    got = BatchedRadixOps(psks, "ripple")._propagate_ripple(pa + pb)
    want = RefOps(rsks)._propagate_ripple(ra + rb)
    assert np.array_equal(np.asarray(want), to_numpy(got))
    assert decrypt_batch_radix(pc, got) == [(x + y) % MOD
                                            for x, y in zip(AV, BV)]


def test_comparisons(keys):
    (rc, rsks), (pc, psks) = keys
    av, bv = [5, 200, 77, 77], [5, 100, 200, 77]
    (ra, rb), (pa, pb) = _pair(keys, av, bv)
    ref_ops, port_ops = RefOps(rsks), BatchedRadixOps(psks, "scan")
    for name, f in (("eq", lambda x, y: x == y), ("ne", lambda x, y: x != y),
                    ("lt", lambda x, y: x < y), ("le", lambda x, y: x <= y),
                    ("gt", lambda x, y: x > y), ("ge", lambda x, y: x >= y)):
        got = _run(ref_ops, port_ops, name, (ra, rb), (pa, pb))
        assert pc.key.decrypt_batch(got).tolist() == [
            int(f(x, y)) for x, y in zip(av, bv)], name


@pytest.mark.parametrize("mode", ["auto", "Ripple", "", None])
def test_unknown_carry_schedule_raises(keys, mode):
    with pytest.raises(ValueError, match="carry schedule"):
        BatchedRadixOps(keys[1][1], mode)
