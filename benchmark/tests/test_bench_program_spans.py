"""The per-layer metrics that read the program's own spans and counters
(`benchmark/metrics/_program.py`): on the CPU, traced runs of the toy API
and batched cells report them, and on every traced request the program's
PBS batches and rows equal the benchmark's own PBS counter's (CPU)."""

import pytest
import torch

from benchmark import harness
from benchmark.metrics import _program

NEW = ("core.pbs_batches_per_op", "core.pbs_rows_per_batch",
       "kernels.launches_per_op", "schedule.self_ms_per_op")


def _traced(toy_root, cell, monkeypatch):
    """The result line and the Run of one traced toy run."""
    torch.set_num_threads(2)
    runs = []
    result = harness._result

    def keep(bench, c, run, checks, device):
        runs.append(run)
        return result(bench, c, run, checks, device)

    monkeypatch.setattr(harness, "_result", keep)
    out = harness.run_cell(harness.Benchmark(toy_root), cell, 2 ** 31 + 41,
                           0.2, trace=True, device="cpu")
    return out, runs[0]


@pytest.mark.parametrize("cell", ["toy_api", "toy_batched"])
def test_program_metrics_are_reported_and_match_the_harness(
        toy_root, monkeypatch, cell):
    out, run = _traced(toy_root, cell, monkeypatch)
    assert out["correct"] is True, out["checks"]
    metrics = out["metrics"]
    assert set(NEW) <= set(metrics), sorted(metrics)
    # the plain twins on the CPU launch no kernel
    assert metrics["kernels.launches_per_op"]["value"] == 0
    assert metrics["schedule.self_ms_per_op"]["value"] > 0
    per = _program.requests(run)
    assert len(per) == len(run.traced) >= 2
    for record, spans in zip(run.traced, per):
        assert _program.root_count(spans, "pbs.batches") == len(record.rows)
        assert _program.root_count(spans, "pbs.rows") == sum(record.rows)
    batches = sum(len(r.rows) for r in run.traced)
    assert metrics["core.pbs_batches_per_op"]["value"] == pytest.approx(
        batches / sum(r.ops for r in run.traced))
    assert metrics["core.pbs_rows_per_batch"]["value"] == pytest.approx(
        sum(sum(r.rows) for r in run.traced) / batches)
    if cell == "toy_api":
        assert {"api.self_ms_per_op", "schedule.graph_pool_mb"} <= set(
            metrics)
        # a CPU key runs its chains directly: no graph, no replay
        assert "schedule.replay_ms_per_op" not in metrics
        assert metrics["schedule.graph_pool_mb"]["value"] == 0


def _program_metrics(bench):
    return [m for m in bench.spec["per_layer"]
            if m["source"] in ("program_span", "program_counter")
            and m["name"].startswith(("core.", "kernels.", "schedule.",
                                      "api."))]


def test_an_untraced_run_or_a_program_without_spans_reads_nothing(
        toy_root, monkeypatch):
    from tfhe_tpu_torch.utils import profiling

    _, run = _traced(toy_root, "toy_batched", monkeypatch)
    bench = harness.Benchmark(toy_root)
    names = [m["name"] for m in _program_metrics(bench)]
    assert all(bench.reader(n)(run) is not None for n in NEW)
    traced, run.traced = run.traced, []
    assert [bench.reader(n)(run) for n in names] == [None] * len(names)
    run.traced = traced
    monkeypatch.delattr(profiling, "spans")
    monkeypatch.delattr(profiling, "counters")
    assert [bench.reader(n)(run) for n in names] == [None] * len(names)

