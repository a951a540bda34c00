"""IntegerServerKey(fused=True), the port's single-program radix schedule
(on the CPU: the chains of integer/fused.py run directly), == the
reference's IntegerServerKey with TFHE_TPU_FUSED_INTEGER=1, word for word
(tolerance 0) with degrees and noise levels, at
PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST with 4 blocks, on the cases of
tests/test_fused_integer.py: every op decrypts to the clear result, one
ciphertext passed as both operands works, and a dirty input takes the host
schedule in both packages.  The reference's FusedIntegerOps runs with its
whole-op `jax.jit` replaced by the traced function itself (each PBS batch
through its per-shape PBS program: the same exact math; the jitted program
is held against the port in test_torch_integer_fused_jit.py)."""

import types

import numpy as np
import pytest

import tfhe_tpu.integer.fused_dispatch as ref_dispatch
import tfhe_tpu.parallel.fused as RF
from tfhe_tpu import integer as ref_integer
from tfhe_tpu.params import PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST as REF_P

from tfhe_tpu_torch import integer
from tfhe_tpu_torch.params import PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST as P
from torch_integer_pair import Pair, host_path_one_thread  # noqa: F401

NB = 4
MOD = 4 ** NB
SEED = 11


@pytest.fixture(scope="module")
def keys():
    rc, rk = ref_integer.gen_keys_radix(REF_P, NB, seed=SEED)
    pc, pk = integer.gen_keys_radix(P, NB, seed=SEED, device="cpu")
    return Pair((rc, rk), (pc, integer.IntegerServerKey(pk.key, fused=True)))


@pytest.fixture(autouse=True)
def reference_fused_unjitted(keys, monkeypatch):
    monkeypatch.setenv("TFHE_TPU_FUSED_INTEGER", "1")
    monkeypatch.setattr(ref_dispatch, "jax", types.SimpleNamespace(
        jit=lambda f: f))
    rk = keys.ref[1]
    monkeypatch.setattr(RF, "keyswitch_then_pbs",
                        lambda ksk, bsk, acc, flat: rk.key._pbs_device(flat,
                                                                       acc))


def _ops_ran_fused(keys, ops):
    """The port's key ran `ops` in the single-program schedule."""
    fns = keys.port[1]._fused_ops._fns
    return {op for op, _ in fns} >= set(ops)


@pytest.mark.parametrize("x,y", [(200, 100), (3, 250)])
def test_add_sub_neg_mul(keys, x, y):
    a, b = keys.enc(x), keys.enc(y)
    assert keys.dec(keys.op("add_parallelized", a, b)) == (x + y) % MOD
    assert keys.dec(keys.op("sub_parallelized", a, b)) == (x - y) % MOD
    assert keys.dec(keys.op("neg_parallelized", a)) == (-x) % MOD
    assert keys.dec(keys.op("mul_parallelized", a, b)) == (x * y) % MOD
    assert _ops_ran_fused(keys, ("add", "sub", "neg", "mul"))


def test_cmp_bitwise_select(keys):
    x, y = 77, 200
    a, b = keys.enc(x), keys.enc(y)
    for name, f in (("eq", lambda: x == y), ("ne", lambda: x != y),
                    ("lt", lambda: x < y), ("le", lambda: x <= y),
                    ("gt", lambda: x > y), ("ge", lambda: x >= y)):
        assert keys.dec(keys.op(f"{name}_parallelized", a, b),
                        "decrypt_bool") == f(), name
    assert keys.dec(keys.op("bitand_parallelized", a, b)) == x & y
    assert keys.dec(keys.op("bitor_parallelized", a, b)) == x | y
    assert keys.dec(keys.op("bitxor_parallelized", a, b)) == x ^ y
    assert keys.dec(keys.op("bitnot", a)) == (MOD - 1) ^ x
    assert keys.dec(keys.op("max_parallelized", a, b)) == max(x, y)
    assert keys.dec(keys.op("min_parallelized", a, b)) == min(x, y)
    cond = keys.enc_bool(x % 2 == 0)
    assert keys.dec(keys.op("if_then_else_parallelized", cond, a, b)) == y
    assert _ops_ran_fused(keys, ("eq", "ne", "lt", "le", "gt", "ge", "band",
                                 "bor", "bxor", "bnot", "max", "min",
                                 "select"))


def test_same_ciphertext_as_both_operands(keys):
    a = keys.enc(7)
    assert keys.dec(keys.op("add_parallelized", a, a)) == 14
    assert keys.dec(keys.op("sub_parallelized", a, a)) == 0
    assert keys.dec(keys.op("eq_parallelized", a, a), "decrypt_bool") is True


def test_dirty_inputs_take_the_host_schedule(keys):
    a, b = keys.enc(255), keys.enc(255)
    dirty = tuple(integer.RadixCiphertext(k.key.unchecked_add_batch(
        x.blocks, y.blocks)) for k, x, y in zip((keys.ref[1], keys.port[1]),
                                                a, b))
    assert int(dirty[1].blocks.degrees.max()) >= 4
    one = keys.enc(1)
    assert keys.port[1]._fused_ops.try_op("add", dirty[1].blocks,
                                          one[1].blocks) is None
    assert keys.dec(keys.op("add_parallelized", dirty, one)) == 255
    clean = tuple(integer.RadixCiphertext(c) for c in keys.op(
        "full_propagate", tuple(d.blocks for d in dirty)))
    assert keys.dec(keys.op("add_parallelized", clean, one)) == 255
