"""The harness finds every part of a cell by name, a new cell needs no
edit of an existing file, the traffic is a function of the seed, the
frozen bound is the smoke's, and no module imports JAX or the JAX
package (CPU)."""

import ast
import hashlib
import json
import os

import pytest
import torch

from conftest import ROOT, add_toy_cells

from benchmark import harness, roofline, traffic
from benchmark.reference import lwe

BENCH = harness.Benchmark(ROOT)
CELLS = [w["name"] for w in BENCH.spec["workloads"]]
HERE = os.path.join(ROOT, "benchmark")


def _python_files(top):
    for dirpath, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imported_tops(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("cell", CELLS)
def test_every_entry_resolves_by_name(cell):
    w = BENCH.workload(cell)
    cfg = BENCH.config(w["config"])
    assert cfg["name"] == w["config"]
    traf = BENCH.traffic(w["traffic"])
    assert hasattr(BENCH.entry(traf["entry"]), "Entry")
    for kind in ("end_to_end", "per_layer"):
        names = [m["name"] for m in BENCH.metrics(cell, kind)]
        assert names
        for name in names:
            assert callable(BENCH.reader(name))
    assert "setup_s" in [m["name"] for m in BENCH.metrics(cell,
                                                          "end_to_end")]


def test_spec_is_consistent():
    spec = BENCH.spec
    e2e = {m["name"] for m in spec["end_to_end"]}
    used = {w["config"] for w in spec["workloads"]}
    assert used == {c["name"] for c in spec["configs"]}
    for c in spec["configs"]:
        assert c["file"].startswith(spec["paths"][0] + "/")
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", CELLS):
            assert w in CELLS
            assert m["moves"] in [x["name"]
                                  for x in BENCH.metrics(w, "end_to_end")]
    assert len(json.dumps(spec)) < 64 * 1024


def _digests(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, root)] = hashlib.sha256(
                open(p, "rb").read()).hexdigest()
    return out


def test_new_cell_and_metric_need_no_edit(toy_root):
    before = {k: v for k, v in _digests(toy_root).items()}
    metric = os.path.join(toy_root, "benchmark", "metrics", "toy.rows.py")
    with open(metric, "w") as fh:
        fh.write("def read(run):\n    return 1.0\n")
    path = os.path.join(toy_root, "BENCHMARK.json")
    spec = json.load(open(path))
    spec["per_layer"].append({"name": "toy.rows", "unit": "rows",
                              "better": "higher", "source": "program_counter",
                              "layer": "schedule", "moves": "ops_per_s",
                              "workloads": ["toy_api"]})
    json.dump(spec, open(path, "w"))
    after = _digests(toy_root)
    changed = [k for k in before if before[k] != after.get(k)]
    # the toy cells were added before `before`; only the spec changes here
    assert changed == ["BENCHMARK.json"]
    bench = harness.Benchmark(toy_root)
    assert [m["name"] for m in bench.metrics("toy_api", "per_layer")
            ][-1] == "toy.rows"
    assert bench.reader("toy.rows")(None) == 1.0
    w = bench.workload("toy_batched")
    assert bench.config(w["config"])["integer_bits"] == 8
    assert bench.traffic(w["traffic"])["entry"] == "batched_radix"


def test_toy_cells_leave_existing_files_unchanged(tmp_path):
    import shutil
    root = str(tmp_path / "c")
    os.makedirs(root)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(HERE, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = _digests(root)
    add_toy_cells(root)
    after = _digests(root)
    assert [k for k in before if before[k] != after[k]] == ["BENCHMARK.json"]
    assert set(after) - set(before)


def _plain(req):
    return {k: v for k, v in req.items() if not isinstance(v, torch.Tensor)}


def _requests(cell, seed, n=12):
    w = BENCH.workload(cell)
    cfg = BENCH.config(w["config"])
    traf = BENCH.traffic(w["traffic"])
    enc = lwe.Encoding.from_config(cfg["parameters"])
    small, glwe = lwe.draw_secret_keys(enc, seed, "cpu")
    entry = BENCH.entry(traf["entry"]).Entry(cfg, traf, seed, "cpu", enc,
                                             small, glwe)
    stream = traffic.requests(traf, seed, "window")
    reqs = [entry.make(*next(stream)) for _ in range(n)]
    return [_plain(r) for r in reqs], [entry.answer(r) for r in reqs]


@pytest.mark.parametrize("cell", CELLS)
def test_traffic_is_a_function_of_the_seed(cell):
    seed = 2 ** 31 + 12345
    a = _requests(cell, seed)
    assert a == _requests(cell, seed)
    assert a != _requests(cell, seed + 1)


@pytest.mark.parametrize("cell", CELLS)
def test_rounds_send_every_kind_once(cell):
    traf = BENCH.traffic(BENCH.workload(cell)["traffic"])
    n = len(traf["mix"])
    kinds = [json.dumps(k, sort_keys=True) for k, _ in
             traffic.requests(traf, 7, "window", rounds=3)]
    for r in range(3):
        assert sorted(kinds[r * n:(r + 1) * n]) == sorted(
            json.dumps(k, sort_keys=True) for k in traf["mix"])


@pytest.mark.parametrize("B", [1, 64, 256, 512, 4224])
def test_frozen_bound_is_the_smokes(B):
    import sys
    sys.path.insert(0, ROOT)
    import chip_smoke

    work = roofline.step_work(B, 2, 1, 2048, roofline.CRT_PRIMES)
    old = chip_smoke.classic_work(B, 2, 1, 2048, roofline.CRT_PRIMES, 64)
    assert work["rotate_decompose"] == old["rotate_decompose"]
    assert work["external_product_crt"] == old["external_product_crt"]
    assert work["step"] == old["pbs_step"]
    bounds = chip_smoke.bounds_ms(B, 2, 1, 2048, roofline.CRT_PRIMES)
    for part, key in (("rotate_decompose", "rotate_decompose"),
                      ("external_product_crt", "external_product_crt"),
                      ("step", "pbs_step")):
        s, by = roofline.bound_s(*work[part],
                                 roofline.LEGACY_PEAK_OPS_PER_S)
        assert (s * 1e3, by) == pytest.approx(bounds[key]) or (
            s * 1e3 == pytest.approx(bounds[key][0]) and by == bounds[key][1])


def test_pbs_batch_bound_is_n_steps():
    peak = 132 * 64 * 1.98e9
    nbytes, ops, _, _ = roofline.least_step_work(512, 2, 1, 2048, 23)
    one = roofline.bound_s(nbytes, ops, peak)[0]
    assert roofline.pbs_batch_min_s(512, 742, 2, 1, 2048, 23, peak) == (
        pytest.approx(742 * one))


@pytest.mark.parametrize("plane_bits, primes", [(64, 4), (32, 3), (16, 2)])
def test_primes_follow_the_products_bit_width(plane_bits, primes):
    # a balanced digit of 22 bits, a signed plane, 2 * 2048 terms, both
    # signs: the product of primes below 2**31 has to exceed 2**(22 +
    # plane_bits - 1 + 12 + 1)
    assert roofline.crt_primes(23, 1, 2, 2048, plane_bits) == primes
    need = 22 + plane_bits - 1 + 12 + 1
    assert 31 * primes >= need > 31 * (primes - 1)


@pytest.mark.parametrize("B", [1, 64, 512, 4224])
def test_least_work_is_below_the_programs(B):
    nbytes, ops, P, M = roofline.least_step_work(B, 2, 1, 2048, 23)
    assert (P, M) == (4, 1)
    prog_bytes, prog_ops = roofline.step_work(B, 2, 1, 2048,
                                              roofline.CRT_PRIMES)["step"]
    assert ops < prog_ops and nbytes < prog_bytes
    for m in (2, 4):
        p = roofline.crt_primes(23, 1, 2, 2048, 64 // m)
        assert ops <= sum(roofline._step_ops(B, 2, 1, 2048, p, m))


def test_no_jax_and_a_reference_of_its_own():
    forbidden = set(harness.FORBIDDEN_MODULES)
    files = list(_python_files(HERE))
    assert files
    for path in files:
        tops = set(_imported_tops(path))
        assert not tops & forbidden, (path, tops & forbidden)
        if os.sep + "reference" + os.sep in path:
            assert "tfhe_tpu_torch" not in tops, path
            assert "benchmark" not in tops, path


def test_forbidden_names_are_compared_whole(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "tfhe_tpu_torch_x",
                        types.ModuleType("tfhe_tpu_torch_x"))
    assert "tfhe_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "tfhe_tpu.api",
                        types.ModuleType("tfhe_tpu.api"))
    assert harness.forbidden_modules() == ["tfhe_tpu"]


@pytest.mark.parametrize("cell", ["toy_api", "toy_batched", "toy_strings"])
def test_toy_cell_runs_correct_on_cpu(toy_root, cell):
    torch.set_num_threads(2)
    bench = harness.Benchmark(toy_root)
    out = harness.run_cell(bench, cell, 2 ** 31 + 99, 0.2, trace=True,
                           device="cpu")
    assert out["correct"] is True, out["checks"]
    assert list(out)[-1] == "checks"
    assert out["checks"]["wrong_blocks"] == {"value": 0, "limit": 0}
    names = set(out["metrics"])
    assert {"pbs_batches_per_op", "pbs_rows_per_batch",
            "setup.keygen_s", "setup.warmup_s"} <= names
    assert out["breakdown"]["idle_gaps"]
    assert out["attempted"] >= 2


def test_a_request_with_no_pbs_fails_the_run(toy_root, monkeypatch):
    """A program that reaches its PBS by a call site the counter does not
    wrap fails the run instead of leaving the PBS metrics out."""
    from benchmark import counters

    torch.set_num_threads(2)
    monkeypatch.setattr(counters.PbsCounter, "install", lambda self: self)
    bench = harness.Benchmark(toy_root)
    with pytest.raises(RuntimeError, match="no PBS batch"):
        harness.run_cell(bench, "toy_batched", 2 ** 31 + 7, 0.2,
                         trace=False, device="cpu")
