"""The port's single-program radix ops (tfhe_tpu_torch.integer.fused, on
the CPU) == tfhe_tpu.parallel.fused's functions of the same name, word for
word (tolerance 0), at PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST with 4 blocks
and two ciphertexts a batch, each package fed its own LUT accumulators
(the reference's FusedIntegerOps table, the port's `integer.fused.lut`),
the port's batches through `pbs_on`.  The reference runs outside its
whole-op `jax.jit`, each PBS batch through its per-shape PBS program (the
same exact math); fused_ks_pbs on a classic key (a multi-bit one in
test_torch_integer_fused_multibit.py).  Every result decrypts to the clear
one and leaves its inputs unchanged."""

import numpy as np
import pytest
import torch

import tfhe_tpu.parallel.fused as RF
from tfhe_tpu import integer as ref_integer
from tfhe_tpu.integer.fused_dispatch import FusedIntegerOps as RefOps
from tfhe_tpu.params import PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST as REF_P

from tfhe_tpu_torch import integer, shortint
from tfhe_tpu_torch.integer import fused as F
from tfhe_tpu_torch.ops.torus import to_numpy
from tfhe_tpu_torch.params import PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST as P
from torch_integer_pair import host_path_one_thread  # noqa: F401

NB = 4
MOD = 4 ** NB
SEED = 11
XS, YS = [200, 37], [100, 219]


@pytest.fixture(scope="module")
def env():
    rc, rk = ref_integer.gen_keys_radix(REF_P, NB, seed=SEED)
    pc, pk = integer.gen_keys_radix(P, NB, seed=SEED, device="cpu")

    def enc(cks, vals):
        return [cks.encrypt(v) for v in vals]

    ra, rb = enc(rc, XS), enc(rc, YS)
    pa, pb = enc(pc, XS), enc(pc, YS)
    ref = dict(ops=RefOps(rk), a=np.stack([c.blocks.data for c in ra]),
               b=np.stack([c.blocks.data for c in rb]),
               cond=np.stack([rc.encrypt_bool(x % 2 == 0).block.data[0]
                              for x in XS]))
    port = dict(a=torch.stack([c.blocks.data for c in pa]),
                b=torch.stack([c.blocks.data for c in pb]),
                cond=torch.stack([pc.encrypt_bool(x % 2 == 0).block.data[0]
                                  for x in XS]))
    assert np.array_equal(ref["a"], to_numpy(port["a"]))
    return rk, pk, pc, ref, port


@pytest.fixture(autouse=True)
def ref_per_shape_pbs(env, monkeypatch):
    rk = env[0]
    monkeypatch.setattr(RF, "keyswitch_then_pbs",
                        lambda ksk, bsk, acc, flat: rk.key._pbs_device(flat,
                                                                       acc))


def _check(env, ref_fn, port_fn, names, inputs, kw, want=None,
           decrypt_bool=False):
    """ref_fn and port_fn on the same inputs and the reference's
    accumulators: equal words; port result decrypted against want."""
    rk, pk, pc, ref, port = env
    accs = [_acc(ref["ops"], n) for n in names]
    r_out = ref_fn(rk.key.ksk, rk.key.bsk, *accs, *[ref[i] for i in inputs],
                   **kw)
    p_accs = F._accs(pk.key, names)
    args = [port[i] for i in inputs]
    before = [a.clone() for a in args]
    p_out = port_fn(F._pbs_on(pk.key.ksk, pk.key.bsk), *p_accs, *args, **kw)
    assert all(a.equal(b) for a, b in zip(args, before))
    assert np.array_equal(np.asarray(r_out), to_numpy(p_out))
    if want is not None:
        if decrypt_bool:
            got = pc.key.decrypt_batch(p_out).tolist()
        else:
            got = [pc.decrypt(integer.RadixCiphertext(
                shortint.ciphertext.ShortintBatch(
                    row, np.zeros(NB, np.int64), 4, 4))) for row in p_out]
        assert got == want
    return p_out


def _acc(ops, name):
    """The accumulator `name` of the reference's FusedIntegerOps table."""
    return ops._acc(name)


MSG = dict(message_modulus=4)
NEG = dict(message_modulus=4, carry_modulus=4, delta=P.delta)


@pytest.mark.parametrize("name,fn,kw,inputs,want", [
    ("fused_radix_add", "add", MSG, ("a", "b"),
     [(x + y) % MOD for x, y in zip(XS, YS)]),
    ("fused_radix_sub", "sub", NEG, ("a", "b"),
     [(x - y) % MOD for x, y in zip(XS, YS)]),
    ("fused_radix_neg", "neg", NEG, ("a",), [-x % MOD for x in XS])])
def test_add_sub_neg(env, name, fn, kw, inputs, want):
    _check(env, getattr(RF, name), getattr(F, name),
           ("state", "resolve", "carry", "msgext"), inputs, kw, want)


def test_mul(env):
    _check(env, RF.fused_radix_mul, F.fused_radix_mul,
           ("mlsb", "mmsb", "msgext", "carryext", "state", "resolve",
            "carry"), ("a", "b"), dict(MSG, carry_modulus=4),
           [x * y % MOD for x, y in zip(XS, YS)])


@pytest.mark.parametrize("negate", [False, True])
def test_eq_ne(env, negate):
    rk, pk, pc, ref, port = env
    cap = (4 * 4 - 1) // 3
    assert pk.key.max_noise_level == cap
    widths = F.eq_chunk_widths(NB, cap)
    assert widths == RF.eq_chunk_widths(NB, cap)
    r_and = {c: rk.key.generate_lookup_table(lambda v, c=c: int(v == c)).acc
             for c in widths}
    r_and["not"] = rk.key.generate_lookup_table(lambda v: int(v == 0)).acc
    p_and = {c: F._lut(pk.key, ("and_sum", c)).acc for c in widths}
    p_and["not"] = F._lut(pk.key, "not").acc
    b_r = ref["a"].copy()
    b_r[1] = ref["b"][1]  # the first pair equal, the second not
    b_p = port["a"].clone()
    b_p[1] = port["b"][1]
    want = RF.fused_radix_eq(
        rk.key.ksk, rk.key.bsk, rk.key.generate_lookup_table_bivariate(
            lambda x, y: int(x == y)).acc.acc, r_and, ref["a"], b_r,
        **NEG, negate=negate)
    got = F.fused_radix_eq(F._pbs_on(pk.key.ksk, pk.key.bsk),
                           F._lut(pk.key, "beq_01").acc, p_and, port["a"],
                           b_p, message_modulus=4, cap=cap, delta=P.delta,
                           negate=negate)
    assert np.array_equal(np.asarray(want), to_numpy(got))
    assert pc.key.decrypt_batch(got).tolist() == (
        [0, 1] if negate else [1, 0])


@pytest.mark.parametrize("op,f", [("lt", lambda x, y: x < y),
                                  ("ge", lambda x, y: x >= y)])
def test_cmp(env, op, f):
    _check(env, RF.fused_radix_cmp, F.fused_radix_cmp,
           ("sign", "sresolve", op), ("a", "b"), MSG,
           [int(f(x, y)) for x, y in zip(XS, YS)], decrypt_bool=True)


@pytest.mark.parametrize("op,f", [("band", lambda x, y: x & y),
                                  ("bxor", lambda x, y: x ^ y)])
def test_bitop(env, op, f):
    _check(env, RF.fused_radix_bitop, F.fused_radix_bitop, (op,),
           ("a", "b"), MSG, [f(x, y) for x, y in zip(XS, YS)])


def test_univariate(env):
    _check(env, RF.fused_radix_univariate, F.fused_radix_univariate,
           ("bnot",), ("a",), {}, [(MOD - 1) ^ x for x in XS])


def test_select(env):
    _check(env, RF.fused_radix_select, F.fused_radix_select,
           ("cthen", "celse", "msgext"), ("cond", "a", "b"), MSG,
           [x if x % 2 == 0 else y for x, y in zip(XS, YS)])


@pytest.mark.parametrize("op,f", [("max", max), ("min", min)])
def test_minmax(env, op, f):
    _check(env, RF.fused_radix_minmax, F.fused_radix_minmax,
           ("sign", "sresolve", op + "then", op + "else", "msgext"),
           ("a", "b"), MSG, [f(x, y) for x, y in zip(XS, YS)])


def test_fused_ks_pbs_classic(env):
    """Any leading axes, a shared accumulator and one per ciphertext."""
    rk, pk, pc, ref, port = env
    r_acc, p_acc = _acc(ref["ops"], "msgext"), F._lut(pk.key, "msgext").acc
    want = RF.fused_ks_pbs(rk.key.ksk, rk.key.bsk, r_acc, ref["a"])
    got = F.fused_ks_pbs(pk.key.ksk, pk.key.bsk, p_acc, port["a"])
    assert got.shape == port["a"].shape
    assert np.array_equal(np.asarray(want), to_numpy(got))
    per = torch.stack(F._accs(pk.key, ("msgext", "carry")))
    got = F.fused_ks_pbs(pk.key.ksk, pk.key.bsk,
                         per[:, None].expand(2, NB, *per.shape[1:]),
                         port["a"])
    assert np.array_equal(np.asarray(want[0]), to_numpy(got[0]))
