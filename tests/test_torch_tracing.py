"""The port's spans and counters (tfhe_tpu_torch.utils.profiling): an API
op's spans nest from `api` through the schedule down to `core`, share
their root's id, and appear as profiler events of their names; the roots
carry the counters' changes; with no profiler running nothing is recorded
and the counters still count; a CUDA graph's capture counts nothing and
each replay adds the captured pass's counts (on a stub graph here, on a
real one in the `cuda`-marked case, which skips without a card: on one,
`python -m pytest -m cuda --noconftest tests/test_torch_tracing.py`)."""

import contextlib
import time
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tfhe_tpu_torch import api, core, integer, shortint
from tfhe_tpu_torch.integer.fused_dispatch import FusedIntegerOps
from tfhe_tpu_torch.ops import fused_pbs
from tfhe_tpu_torch.params import PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST as P
from tfhe_tpu_torch.utils import profiling

SEED = 77
X, Y = 201, 77


def _since(t0):
    return [s for s in profiling.spans() if s.start_ns >= t0]


@pytest.fixture(scope="module")
def api_keys():
    torch.set_num_threads(2)
    config = api.ConfigBuilder.default().use_custom_parameters(P).build()
    cks, sks = api.generate_keys(config, seed=SEED, device="cpu", fused=True)
    api.set_server_key(sks)
    yield cks, api.FheUint8.encrypt(X, cks), api.FheUint8.encrypt(Y, cks)
    api.set_server_key(None)


@pytest.fixture(scope="module")
def traced_add(api_keys):
    """One API add on a fused CPU key under torch.profiler: its spans, the
    profiler's event names and the decrypted sum."""
    cks, a, b = api_keys
    t0 = time.perf_counter_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = a + b
    return _since(t0), {e.name for e in prof.events()}, out.decrypt(cks)


def test_spans_nest_from_the_api_down_to_core(traced_add):
    spans, _, total = traced_add
    assert total == (X + Y) % 256
    by_id = {s.span_id: s for s in spans}
    (root,) = [s for s in spans if s.parent_id is None]
    assert root.name == "api.add" and root.root_id == root.span_id
    (sched,) = [s for s in spans if s.name == "schedule.fused.add"]
    pbs = [s for s in spans if s.name == "core.pbs"]
    assert sched.parent_id == root.span_id and pbs
    assert {s.parent_id for s in pbs} == {sched.span_id}
    assert {s.root_id for s in spans} == {root.span_id}
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent_id is not None:
            parent = by_id[s.parent_id]
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    assert {s.attrs["rows"] for s in pbs} == {4}  # one row a block


def test_roots_carry_the_batches_and_rows_of_their_pbs_spans(traced_add):
    spans = traced_add[0]
    pbs = [s for s in spans if s.name == "core.pbs"]
    (root,) = [s for s in spans if s.parent_id is None]
    assert root.counts["pbs.batches"] == len(pbs) > 1
    assert root.counts["pbs.rows"] == sum(s.attrs["rows"] for s in pbs)
    for s in pbs:
        assert s.counts == {"pbs.batches": 1, "pbs.rows": s.attrs["rows"]}


def test_every_span_is_a_profiler_event_of_its_name(traced_add):
    spans, names, _ = traced_add
    assert {s.name for s in spans} == {"api.add", "schedule.fused.add",
                                       "core.pbs"}
    assert {s.name for s in spans} <= names


def test_without_a_profiler_nothing_is_recorded_and_counters_count(
        api_keys):
    cks, a, b = api_keys
    assert profiling.annotate("core.pbs", rows=1) is profiling._OFF
    n, before = len(profiling.spans()), profiling.counters()
    t0 = time.perf_counter_ns()
    assert (a - b).decrypt(cks) == (X - Y) % 256
    assert len(profiling.spans()) == n and not _since(t0)
    moved = profiling.changes_since(before)
    assert moved["pbs.batches"] > 1 and moved["pbs.rows"] > 1
    assert set(moved) == {"pbs.batches", "pbs.rows"}  # no kernel on the CPU


class _StubGraph:
    replays = 0

    def replay(self):
        type(self).replays += 1


def _stub_cuda(monkeypatch):
    """torch.cuda's stream, graph and allocator calls as the capture makes
    them, on the CPU: a graph that records nothing and a pool that grows
    4096 bytes a capture."""
    stream = types.SimpleNamespace(wait_stream=lambda other: None)
    reserved = iter(range(0, 1 << 20, 4096))
    cuda = torch.cuda
    monkeypatch.setattr(cuda, "Stream", lambda device=None: stream)
    monkeypatch.setattr(cuda, "current_stream", lambda device=None: stream)
    monkeypatch.setattr(cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(cuda, "CUDAGraph", _StubGraph)
    monkeypatch.setattr(cuda, "graph", lambda g: contextlib.nullcontext())
    monkeypatch.setattr(cuda, "memory_reserved",
                        lambda device=None: next(reserved))


def test_a_capture_counts_nothing_and_each_replay_adds_its_counts(
        monkeypatch):
    torch.set_num_threads(2)
    cks, sks = shortint.gen_keys(P, seed=SEED, device="cpu")
    lut = sks.generate_lookup_table(lambda v: (v + 1) % 4)
    data = cks.encrypt_batch([0, 1, 2]).data
    k1 = fused_pbs.rotate_decompose

    def chain(x):  # a chain of two batches that "launches" 5 K1s
        k1.launches += 5
        y = core.keyswitch_then_pbs(sks.ksk, sks.bsk, lut.acc, x[0])
        return core.keyswitch_then_pbs(sks.ksk, sks.bsk, lut.acc, y)[None]

    once = {"pbs.batches": 2, "pbs.rows": 6,
            "fused_pbs.rotate_decompose.launches": 5}
    _stub_cuda(monkeypatch)
    fops = FusedIntegerOps(types.SimpleNamespace(key=sks))
    key, dev = ("stub", ((1, 3, data.shape[-1]),)), [data[None]]
    before = profiling.counters()
    t0 = time.perf_counter_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        fops._capture(key, chain, dev)
    # the eager warm-up ran and counts; the captured pass does not
    assert profiling.changes_since(before) == dict(
        once, **{"schedule.graph_pool_bytes": 4096})
    assert fops._graph_counts[key] == once
    spans = _since(t0)
    (cap,) = [s for s in spans if s.name == "schedule.capture"]
    (eager,) = [s for s in spans if s.name == "schedule.capture.eager"]
    (rec,) = [s for s in spans if s.name == "schedule.capture.record"]
    assert eager.parent_id == rec.parent_id == cap.span_id
    assert eager.counts == once and rec.counts == {}
    assert cap.attrs == {"op": "stub"}
    before = profiling.counters()
    _StubGraph.replays = 0
    for _ in range(2):
        out = fops._replay(key, chain, dev)
    assert _StubGraph.replays == 2
    assert profiling.changes_since(before) == {k: 2 * v
                                               for k, v in once.items()}
    assert out.shape == (1, 3, data.shape[-1])


OPS = {"add": lambda k, a, b: k.add_parallelized(a, b),
       "mul": lambda k, a, b: k.mul_parallelized(a, b)}


@pytest.mark.cuda
@pytest.mark.parametrize("op", sorted(OPS))
def test_replays_count_as_eager_runs_on_the_card(op):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cks, sks = integer.gen_keys_radix(P, 4, seed=SEED, device="cuda")
    key = integer.IntegerServerKey(sks.key, fused=True)
    a, b = cks.encrypt(X), cks.encrypt(Y)

    def moved(run):
        torch.cuda.synchronize()
        before = profiling.counters()
        run()
        torch.cuda.synchronize()
        out = profiling.changes_since(before)
        out.pop("schedule.graph_pool_bytes", None)
        return out

    first = moved(lambda: OPS[op](key, a, b))  # warm-up, capture, replay
    assert any(k[0] == op for k in key._fused_ops._graphs)
    replays = moved(lambda: [OPS[op](key, a, b) for _ in range(2)])
    eager = moved(lambda: [key._fused_ops.try_op(op, a.blocks, b.blocks,
                                                 graph=False)
                           for _ in range(2)])
    assert replays == eager == first
    assert eager["pbs.batches"] > 1
    assert eager["fused_pbs.rotate_decompose.launches"] == \
        eager["fused_pbs.external_product_crt.launches"] == \
        P.lwe_dimension * eager["pbs.batches"]


@pytest.mark.cuda
@pytest.mark.parametrize("op", sorted(OPS))
def test_multi_bit_replays_count_as_eager_runs_on_the_card(op):
    """The same on a multi-bit key: K8's two kernels a group step, and the
    multi-bit counters, which a replay adds as the eager chain does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tfhe_tpu_torch.params import (
        PARAM_MULTI_BIT_MESSAGE_2_CARRY_2_GROUP_2_TEST as MB)

    cks, sks = integer.gen_keys_radix(MB, 4, seed=SEED, device="cuda")
    key = integer.IntegerServerKey(sks.key, fused=True)
    a, b = cks.encrypt(X), cks.encrypt(Y)

    def moved(run):
        torch.cuda.synchronize()
        before = profiling.counters()
        out = run()
        torch.cuda.synchronize()
        changes = profiling.changes_since(before)
        changes.pop("schedule.graph_pool_bytes", None)
        return changes, out

    first, _ = moved(lambda: OPS[op](key, a, b))  # warm-up, capture, replay
    assert any(k[0] == op for k in key._fused_ops._graphs)
    replays, out = moved(lambda: OPS[op](key, a, b))
    eager, _ = moved(lambda: key._fused_ops.try_op(op, a.blocks, b.blocks,
                                                   graph=False))
    assert replays == eager and first == {k: 2 * v for k, v in eager.items()}
    want = {"add": (X + Y) % 256, "mul": (X * Y) % 256}[op]
    assert cks.decrypt(out) == want
    batches = eager["pbs.batches"]
    steps = MB.lwe_dimension // MB.grouping_factor
    kspec = sks.key.bsk.kspec
    assert batches > 1 and eager["pbs.multibit.batches"] == batches
    assert eager["pbs.multibit.rows"] == eager["pbs.rows"]
    assert eager["fused_multibit.multibit_combine.launches"] == \
        eager["fused_multibit.multibit_external_product.launches"] == \
        steps * batches
    assert eager["fused_multibit.multibit_combine.key_bytes"] == \
        steps * batches * kspec[0].numel() * kspec.element_size()
