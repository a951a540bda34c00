"""The port's batched string ops (tfhe_tpu_torch.strings.batched, on the
CPU) == tfhe_tpu.strings.batched, word for word, at
PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST on the texts of
tests/test_batched_strings.py: BatchedStringOps.contains and find
(pair-packed block equality), and the single-program fused_strings_contains
against tfhe_tpu.parallel.fused's, with the reference's per-shape PBS
programs; every output decrypts to Python's `str` result and the inputs
are unchanged."""

import numpy as np
import pytest

import tfhe_tpu.parallel.fused as ref_fused
from tfhe_tpu import strings as ref_strings
from tfhe_tpu.strings.batched import BatchedStringOps as RefOps
from tfhe_tpu.strings.batched import encrypt_batch_strings as ref_encrypt

from tfhe_tpu_torch import strings
from tfhe_tpu_torch.integer import fused as F
from tfhe_tpu_torch.integer.fused import fused_strings_contains
from tfhe_tpu_torch.ops.torus import to_numpy
from tfhe_tpu_torch.strings.batched import (BatchedStringOps,
                                            encrypt_batch_strings)
from torch_integer_pair import host_path_one_thread  # noqa: F401

TEXTS = ["abcab", "xxabz", "zzzzz", "ab"]
MAXLEN = 6
SEED = 11


@pytest.fixture(scope="module")
def env():
    rc, rk = ref_strings.gen_keys_test(seed=SEED)
    pc, pk = strings.gen_keys_test(seed=SEED, device="cpu")
    rb, pb = ref_encrypt(rc, TEXTS, MAXLEN), encrypt_batch_strings(
        pc, TEXTS, MAXLEN)
    assert np.array_equal(np.asarray(rb), to_numpy(pb))
    return (rc, RefOps(rk.sks), rb), (pc, BatchedStringOps(pk.sks), pb)


def _dec(cks, blocks):
    sz = blocks.shape[-1]
    return cks.integer_key.key.decrypt_batch(
        blocks.reshape(-1, sz)).reshape(blocks.shape[:-1]).tolist()


def test_batched_contains(env):
    (_, rops, rb), (pc, pops, pb) = env
    before = pb.clone()
    out = pops.contains(pb, "ab")
    assert pb.equal(before)
    assert np.array_equal(np.asarray(rops.contains(rb, "ab")), to_numpy(out))
    assert _dec(pc, out) == [int("ab" in t) for t in TEXTS]


def test_batched_find(env):
    (_, rops, rb), (pc, pops, pb) = env
    found, firsts = pops.find(pb, "ab")
    r_found, r_firsts = rops.find(rb, "ab")
    assert np.array_equal(np.asarray(r_found), to_numpy(found))
    assert np.array_equal(np.asarray(r_firsts), to_numpy(firsts))
    assert _dec(pc, found) == [int("ab" in t) for t in TEXTS]
    for t, row in zip(TEXTS, _dec(pc, firsts)):
        want = [0] * len(row)
        if "ab" in t:
            want[t.find("ab")] = 1
        assert row == want, t


def test_fused_strings_contains(env, monkeypatch):
    """The single-program contains, each PBS batch through the reference's
    per-shape PBS program (the same math as its whole-op jit)."""
    (rc, rops, rb), (pc, pops, pb) = env
    rsks, psks = rops.sks, pops.sks
    monkeypatch.setattr(ref_fused, "keyswitch_then_pbs",
                        lambda ksk, bsk, acc, flat: rsks._pbs_device(flat,
                                                                     acc))
    msg = psks.message_modulus
    pattern = "ab"
    digits = tuple(tuple((ord(c) // msg**j) % msg for j in range(4))
                   for c in pattern)
    funcs = {
        "sign": lambda x, y: 0 if x == y else (1 if x < y else 2),
        "resolve": lambda high, low: min(low if high == 0 else high, 2),
        "and": lambda a, b: int(bool(a) and bool(b)),
        "or": lambda a, b: int(bool(a) or bool(b))}
    biv = {k: rsks.generate_lookup_table_bivariate(f).acc.acc
           for k, f in funcs.items()}
    eq0 = rsks.generate_lookup_table(lambda s: int(s == 0)).acc

    kw = dict(pat_digits=digits, message_modulus=msg, delta=psks.delta)
    want = ref_fused.fused_strings_contains(
        rsks.ksk, rsks.bsk, biv["sign"], biv["resolve"], eq0, biv["and"],
        biv["or"], rb, **kw)
    before = pb.clone()
    got = fused_strings_contains(F._pbs_on(psks.ksk, psks.bsk),
                                 *F._accs(psks, F._CONTAINS_LUTS), pb,
                                 **kw)
    assert pb.equal(before)
    assert np.array_equal(np.asarray(want), to_numpy(got))
    assert pc.integer_key.key.decrypt_batch(got).tolist() == [
        int(pattern in t) for t in TEXTS]
