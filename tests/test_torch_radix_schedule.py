"""One clean-block radix schedule (tfhe_tpu_torch.integer.fused), two
fronts.

- BatchedRadixOps(..., "scan") and FusedIntegerOps's chain run each of add
  sub neg mul eq ne lt le gt ge on the same two integers of 4 blocks at
  PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST (CPU keys): equal words, and the
  same rows and accumulator a PBS batch in the same order, each batch
  through its front's own call site (the shortint key's `_pbs_device`,
  `integer.fused.keyswitch_then_pbs`).
- With no keys, over the whole LUT domain range(total_modulus): key
  shells whose LUT is its table ([1, total_modulus] words) run every op of
  each front, the port's and the reference's, on zero words with a
  recording batch function; each port front's batches must carry its
  reference's tables (tfhe_tpu.integer.batched for the waves,
  tfhe_tpu.integer.fused_dispatch for the chains, tfhe_tpu.parallel.fused's
  contains and mesh LUTs for the table's names), at a set where the two
  bivariate forms agree and at one with carry > msg, where they do not."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfhe_tpu.integer.fused_dispatch as ref_dispatch
import tfhe_tpu.parallel.fused as RF
import tfhe_tpu.parallel.sharding as ref_sharding
from tfhe_tpu.integer.batched import BatchedRadixOps as RefBatched
from tfhe_tpu.params import PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST as REF_P
from tfhe_tpu.params.compact_pk_params import \
    PARAM_MESSAGE_2_CARRY_3_COMPACT_PK_KS_PBS as REF_PK
from tfhe_tpu.shortint import server_key as ref_server_key

from tfhe_tpu_torch import integer
from tfhe_tpu_torch.integer import fused as F
from tfhe_tpu_torch.integer.batched import (BatchedRadixOps,
                                            decrypt_batch_radix,
                                            encrypt_batch_radix)
from tfhe_tpu_torch.integer.fused_dispatch import FusedIntegerOps
from tfhe_tpu_torch.params import PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST as P
from tfhe_tpu_torch.params.compact_pk_params import \
    PARAM_MESSAGE_2_CARRY_3_COMPACT_PK_KS_PBS
from tfhe_tpu_torch.shortint import server_key

NB = 4
MOD = 4 ** NB
XS, YS = [200, 77], [100, 77]
CLEAR = {"add": lambda x, y: (x + y) % MOD, "sub": lambda x, y: (x - y) % MOD,
         "neg": lambda x, y: -x % MOD, "mul": lambda x, y: x * y % MOD,
         "eq": lambda x, y: int(x == y), "ne": lambda x, y: int(x != y),
         "lt": lambda x, y: int(x < y), "le": lambda x, y: int(x <= y),
         "gt": lambda x, y: int(x > y), "ge": lambda x, y: int(x >= y)}


@pytest.fixture(scope="module")
def keys():
    torch.set_num_threads(2)
    cks, sks = integer.gen_keys_radix(P, NB, seed=13, device="cpu")
    return cks, sks, (encrypt_batch_radix(cks, XS, NB),
                      encrypt_batch_radix(cks, YS, NB))


def _recorded(monkeypatch, batches):
    """Both call sites append (rows, accumulator) of every batch."""
    chain_site = F.keyswitch_then_pbs
    wave_site = server_key.ServerKey._pbs_device

    def chain(ksk, bsk, acc, rows, mode=None):
        batches.append((rows.shape[0], acc, "chain"))
        return chain_site(ksk, bsk, acc, rows, mode)

    def wave(key, rows, acc):
        batches.append((rows.shape[0], acc, "wave"))
        return wave_site(key, rows, acc)

    monkeypatch.setattr(F, "keyswitch_then_pbs", chain)
    monkeypatch.setattr(server_key.ServerKey, "_pbs_device", wave)


@pytest.mark.parametrize("op", sorted(CLEAR))
def test_fronts_run_one_schedule(keys, op, monkeypatch):
    cks, sks, (a, b) = keys
    args = (a,) if op == "neg" else (a, b)
    chained = []
    _recorded(monkeypatch, chained)
    got = getattr(BatchedRadixOps(sks.key, "scan"), op)(*args)
    batched, chained[:] = chained[:], []
    fops = FusedIntegerOps(sks)
    want = fops._fn(op, tuple(tuple(x.shape) for x in args))(*args)
    assert torch.equal(got, want)
    assert {site for *_, site in batched} == {"wave"}
    assert {site for *_, site in chained} == {"chain"}
    assert [r for r, *_ in batched] == [r for r, *_ in chained]
    assert all(torch.equal(x, y)
               for (_, x, _), (_, y, _) in zip(batched, chained))
    clear = [CLEAR[op](x, y) for x, y in zip(XS, YS)]
    if got.dim() == 2:  # [B, sz] boolean blocks
        assert cks.key.decrypt_batch(got).tolist() == clear
    else:
        assert decrypt_batch_radix(cks, got) == clear


# -- the LUTs of each front, against the reference's, with no keys ----------


class _Shell:
    """A shortint key's fields and a LUT that is its table [1, total]."""

    def __init__(self, params):
        self.params = params
        self.message_modulus = params.message_modulus
        self.carry_modulus = params.carry_modulus
        self.max_noise_level = (params.total_modulus - 1) // (
            params.message_modulus - 1)
        self.delta = params.delta
        self.ksk = self.bsk = self.mode = None
        self.built, self.batches = [], []

    def table(self, f):
        t = [int(f(i)) % (1 << 64) for i in range(self.params.total_modulus)]
        self.built.append(t)
        return t

    def _pbs_device(self, rows, acc):
        self.batches.append((rows.shape[0], np.asarray(acc).tolist()))
        return rows


class PortShell(_Shell, server_key.ServerKey):
    def generate_lookup_table(self, f):
        t = self.table(f)
        return server_key.LookupTable(acc=torch.tensor([t]), degree=max(t))


class RefShell(_Shell, ref_server_key.ServerKey):
    def generate_lookup_table(self, f):
        t = self.table(f)
        return ref_server_key.LookupTable(acc=np.asarray([t], np.uint64),
                                          degree=max(t))


CHAIN_OPS = sorted(CLEAR) + ["band", "bor", "bxor", "bnot", "select", "max",
                             "min"]
SHAPE = (2, NB, 3)


def _inputs(op, zeros):
    args = [zeros(SHAPE)] * (1 if op in ("neg", "bnot") else 2)
    return ([zeros(SHAPE[::2])] if op == "select" else []) + args


def _batches(shell, run):
    shell.batches = []
    run()
    return shell.batches


@pytest.mark.parametrize("params,ref_params", [
    (P, REF_P), (PARAM_MESSAGE_2_CARRY_3_COMPACT_PK_KS_PBS, REF_PK)],
    ids=["m2c2_test", "m2c3_compact_pk"])
def test_each_front_keeps_its_references_luts(params, ref_params,
                                              monkeypatch):
    port, ref = PortShell(params), RefShell(ref_params)
    msg = params.message_modulus
    # the two bivariate forms differ off the clean domain iff carry > msg
    assert (F._lut(port, "sign").acc.equal(F._lut(port, "sign", True).acc)
            == (params.carry_modulus <= msg))
    pzeros = lambda s: torch.zeros(s, dtype=torch.int64)  # noqa: E731
    rzeros = lambda s: jnp.zeros(s, jnp.uint64)  # noqa: E731

    # the waves, both carry schedules
    for mode in ("scan", "ripple"):
        monkeypatch.setenv("TFHE_TPU_CARRY_MODE", mode)
        ops, ref_ops = BatchedRadixOps(port, mode), RefBatched(ref)
        for op in sorted(CLEAR) if mode == "scan" else sorted(F._CARRY_OPS):
            want = _batches(ref, lambda: getattr(ref_ops, op)(
                *_inputs(op, rzeros)))
            got = _batches(port, lambda: getattr(ops, op)(
                *_inputs(op, pzeros)))
            assert got == want, (mode, op)

    # the chains: the reference's FusedIntegerOps table and its chains
    monkeypatch.setattr(ref_dispatch, "jax",
                        types.SimpleNamespace(jit=lambda f: f))
    monkeypatch.setattr(RF, "keyswitch_then_pbs",
                        lambda ksk, bsk, acc, flat: ref._pbs_device(flat,
                                                                    acc))
    monkeypatch.setattr(F, "keyswitch_then_pbs",
                        lambda ksk, bsk, acc, rows, mode=None:
                        port._pbs_device(rows, acc))
    fops = FusedIntegerOps(types.SimpleNamespace(key=port))
    ref_fops = ref_dispatch.FusedIntegerOps(types.SimpleNamespace(key=ref))
    for op in CHAIN_OPS:
        rargs, pargs = _inputs(op, rzeros), _inputs(op, pzeros)
        shape = tuple(tuple(x.shape) for x in pargs)
        want = _batches(ref, lambda: ref_fops._fn(op, shape)(
            None, None, *rargs))
        got = _batches(port, lambda: fops._fn(op, shape)(*pargs))
        assert got == want, op

    # the mesh's LUTs (tfhe_tpu.parallel.fused: the tables its make_*
    # build, in their order), on a one-device mesh with no keys to place
    monkeypatch.setattr(ref_sharding, "shard_server_key",
                        lambda mesh, bsk, ksk: (bsk, ksk))
    monkeypatch.setattr(ref_sharding, "key_shardings",
                        lambda mesh, bsk, ksk: (None, None))
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                             ("batch", "poly"))
    for make, names in (
            (lambda: RF.make_sharded_strings_contains(mesh, ref, "ab"),
             F._CONTAINS_LUTS),
            (lambda: RF.make_sharded_radix_mul(mesh, ref, NB),
             F._MUL_LUTS + ("state", "resolve", "carry")),
            (lambda: RF.make_blockshard_radix_add(mesh, ref, NB),
             F._CARRY_LUTS)):
        ref.built = []
        make()
        assert [F._lut(port, n).acc[0].tolist() for n in names] == ref.built
