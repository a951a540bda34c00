"""The high-level API on a multi-bit parameter set, on the CPU, at
PARAM_MULTI_BIT_MESSAGE_2_CARRY_2_GROUP_2_TEST with FheUint8: with
`fused=True` (the single-program radix chains) add, mul, eq and
if_then_else equal tfhe_tpu's API word for word (tolerance 0) in its own
single-program schedule (TFHE_TPU_FUSED_INTEGER=1, its whole-op `jax.jit`
replaced by the traced function, each PBS batch through its shortint key)
and decrypt to the clear answer; `BatchedRadixOps` add and lt at B = 2
decrypt to the clear answers; and the multi-bit counters (`pbs.multibit.*`
and the combine's `key_bytes`) count one traced request's batches, rows
and key bytes, which a graph's capture keeps and each replay adds again
(on a stub graph here)."""

import time
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import tfhe_tpu.core.multibit as ref_multibit
import tfhe_tpu.integer.fused_dispatch as ref_dispatch
from tfhe_tpu.params import (
    PARAM_MULTI_BIT_MESSAGE_2_CARRY_2_GROUP_2_TEST as REF_MB)

from tfhe_tpu_torch import api
from tfhe_tpu_torch.integer.batched import (BatchedRadixOps,
                                            decrypt_batch_radix,
                                            encrypt_batch_radix)
from tfhe_tpu_torch.params import (
    PARAM_MULTI_BIT_MESSAGE_2_CARRY_2_GROUP_2_TEST as MB)
from tfhe_tpu_torch.utils import profiling
from test_torch_tracing import _stub_cuda
from torch_api_pair import make_pair

SEED = 23
X, Y = 201, 77
MULTIBIT = ("pbs.multibit.batches", "pbs.multibit.rows",
            "fused_multibit.multibit_combine.key_bytes")


@pytest.fixture(scope="module")
def keys():
    torch.set_num_threads(2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TFHE_TPU_FUSED_INTEGER", "1")
        mp.setattr(ref_dispatch, "jax",
                   types.SimpleNamespace(jit=lambda f: f))
        pair = make_pair(REF_MB, MB, seed=SEED, fused=True)
        rk = pair.ref[1].integer_key.key
        mp.setattr(ref_multibit, "keyswitch_then_multi_bit_pbs",
                   lambda ksk, bsk, acc, flat: rk._pbs_device(flat, acc))
        yield pair
    api.set_server_key(None)


@pytest.fixture(autouse=True)
def server_keys_set(keys):
    keys.set_keys()


def test_the_config_takes_the_multi_bit_set(keys):
    cks, sks = keys.port
    assert cks.config.parameters is MB
    shortint_key = sks.integer_key.key
    assert shortint_key.is_multi_bit and shortint_key.mode == "scan3"
    assert api._blocks_for_bits(MB, 8) == 4


@pytest.mark.parametrize("op,fn,want", [
    ("add", lambda x, y, c: x + y, (X + Y) % 256),
    ("mul", lambda x, y, c: x * y, (X * Y) % 256),
    ("eq", lambda x, y, c: x.eq(y), False),
    ("select", lambda x, y, c: c.if_then_else(x, y), Y),
])
def test_fused_ops_equal_the_reference(keys, op, fn, want):
    a, b = keys.enc("FheUint8", X), keys.enc("FheUint8", Y)
    c = keys.enc("FheBool", False)
    assert keys.dec(keys.run(fn, a, b, c)) == want
    # both packages ran their single-program chain
    assert keys.ref[1].integer_key._fused_ops is not None
    fns = keys.port[1].integer_key._fused_ops._fns
    assert op in {name for name, _ in fns}


def test_batched_add_and_lt(keys):
    cks, sks = keys.port
    ops = BatchedRadixOps(sks.integer_key.key, "scan")
    xs, ys = [X, 3], [Y, 250]
    a = encrypt_batch_radix(cks.radix, xs, 4)
    b = encrypt_batch_radix(cks.radix, ys, 4)
    assert decrypt_batch_radix(cks.radix, ops.add(a, b)) == [
        (x + y) % 256 for x, y in zip(xs, ys)]
    lt = ops.lt(a, b)  # [B, sz]: one boolean block each
    assert [bool(v) for v in cks.radix.key.decrypt_batch(lt).tolist()] == [
        x < y for x, y in zip(xs, ys)]


def _group_key_bytes(sks):
    kspec = sks.integer_key.key.bsk.kspec
    return kspec[0].numel() * kspec.element_size()


def test_one_traced_request_counts_its_multi_bit_batches(keys):
    cks, sks = keys.port
    a = api.FheUint8.encrypt(X, cks)
    b = api.FheUint8.encrypt(Y, cks)
    t0 = time.perf_counter_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        out = a + b
    assert out.decrypt(cks) == (X + Y) % 256
    spans = [s for s in profiling.spans() if s.start_ns >= t0]
    (root,) = [s for s in spans if s.parent_id is None]
    pbs = [s for s in spans if s.name == "core.pbs"]
    assert root.name == "api.add" and len(pbs) > 1
    assert {(s.attrs["mode"], s.attrs["grouping_factor"]) for s in pbs} == {
        ("scan3", MB.grouping_factor)}
    batches, rows = len(pbs), sum(s.attrs["rows"] for s in pbs)
    steps = MB.lwe_dimension // MB.grouping_factor
    assert root.counts["pbs.multibit.batches"] == \
        root.counts["pbs.batches"] == batches
    assert root.counts["pbs.multibit.rows"] == \
        root.counts["pbs.rows"] == rows
    assert root.counts["fused_multibit.multibit_combine.key_bytes"] == \
        batches * steps * _group_key_bytes(sks)


def test_a_capture_keeps_the_multi_bit_counts_and_replays_add_them(
        keys, monkeypatch):
    cks, sks = keys.port
    fops = sks.integer_key._fused_ops
    a = api.FheUint8.encrypt(X, cks).inner.blocks
    b = api.FheUint8.encrypt(Y, cks).inner.blocks
    dev = [a.data[None], b.data[None]]
    key = ("add", tuple(tuple(d.shape) for d in dev))
    fn = fops._fn(*key)
    before = profiling.counters()
    fn(*dev)
    once = {k: v for k, v in profiling.changes_since(before).items()
            if k in MULTIBIT}
    assert set(once) == set(MULTIBIT)

    _stub_cuda(monkeypatch)
    stub_key = ("stub_add", key[1])
    fops._capture(stub_key, fn, dev)
    assert {k: v for k, v in fops._graph_counts[stub_key].items()
            if k in MULTIBIT} == once
    for n in (1, 2):
        before = profiling.counters()
        for _ in range(n):
            fops._replay(stub_key, fn, dev)
        moved = profiling.changes_since(before)
        assert {k: moved.get(k, 0) for k in MULTIBIT} == {
            k: n * v for k, v in once.items()}

