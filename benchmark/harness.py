"""One run of one cell: set-up, the measured window, the traced slice, the
check, and the result line.

Everything a cell is made of is found by name: the workload in
BENCHMARK.json names its configuration (whose entry gives the file) and its
traffic (benchmark/traffic/<traffic>.json); the traffic names its entry
(benchmark/entries/<entry>.py); every metric is read by
benchmark/metrics/<metric>.py.  So a later change adds a configuration, a
traffic mix, an entry or a metric as files of its own, and edits none.

The measured window is a closed loop of one client: a request is sent when
the previous one has completed on the card (synchronised), each is timed
on the host clock, and the window ends when the last request started
before `seconds` ran out completes.  Each request's output blocks are
copied to the host, and once the window has closed the plain reference
decrypts them with the benchmark's own key and compares every block with
the clear function's answer.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import sys
import time
from dataclasses import dataclass, field
from typing import List, Optional

from .counters import PbsCounter
from .reference import lwe
from . import traffic as traffic_gen

HERE = os.path.dirname(os.path.abspath(__file__))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "tfhe_tpu")


def _checked_name(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"not a valid name: {name!r}")
    return name


def _load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


class Benchmark:
    """BENCHMARK.json at `root`, and the files its names lead to."""

    def __init__(self, root: str):
        self.root = root
        self.spec = _load_json(os.path.join(root, "BENCHMARK.json"))
        self.here = os.path.join(root, "benchmark")

    def _entry(self, key: str, name: str) -> dict:
        found = [e for e in self.spec[key] if e["name"] == name]
        if len(found) != 1:
            raise KeyError(f"{key}: no single entry named {name!r}")
        return found[0]

    def workload(self, name: str) -> dict:
        return self._entry("workloads", name)

    def config(self, name: str) -> dict:
        return _load_json(os.path.join(self.root,
                                       self._entry("configs", name)["file"]))

    def traffic(self, name: str) -> dict:
        return _load_json(os.path.join(self.here, "traffic",
                                       f"{_checked_name(name)}.json"))

    def metrics(self, workload: str, kind: str) -> List[dict]:
        """The `kind` ("end_to_end" or "per_layer") metrics a cell
        reports: those without `workloads`, and those that list it."""
        return [m for m in self.spec[kind]
                if workload in m.get("workloads", [workload])]

    def entry(self, name: str):
        """benchmark/entries/<name>.py, as a module of the benchmark
        package (its relative imports resolve there)."""
        return _load(os.path.join(self.here, "entries",
                                  f"{_checked_name(name)}.py"),
                     f"benchmark.entries.{name}")

    def reader(self, metric: str):
        """The `read(run)` function of benchmark/metrics/<metric>.py."""
        return _load(os.path.join(self.here, "metrics",
                                  f"{_checked_name(metric)}.py"),
                     f"benchmark.metrics.{metric.replace('.', '_')}").read


def _load(path: str, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Record:
    """One request: its kind, host-clock start and end, the ops it
    counts, the row counts of its PBS batches, the request itself and its
    output blocks (host copy)."""

    kind: str
    t0: float
    t1: float
    ops: int
    rows: List[int]
    request: dict
    out: object


@dataclass
class Run:
    """What the metric readers read."""

    workload: str
    config: dict
    traffic: dict
    setup: dict
    records: List[Record]
    window_s: float
    peak_bytes: int
    traced: List[Record] = field(default_factory=list)
    trace: Optional[dict] = None
    peaks: Optional[dict] = None


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the measured process must
    not hold, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN_MODULES))


def _sync(device: str) -> None:
    if device == "cuda":
        import torch
        torch.cuda.synchronize()


def _pbs_rows(counter, kind: str) -> List[int]:
    """The row counts of the request just served.  Every request of a cell
    runs at least one keyswitch + PBS batch, so none recorded means that
    the program reached its PBS by a call site the counter does not see:
    the run fails rather than leave the PBS metrics out."""
    rows = counter.end()
    if not rows:
        raise RuntimeError(f"request {kind!r} recorded no PBS batch: the "
                           "PBS counter no longer sees the program's PBS")
    return rows


def _serve(entry, counter, request, device, clock) -> Record:
    counter.begin()
    t0 = clock()
    out = entry.submit(request)
    _sync(device)
    t1 = clock()
    kind = entry.kind(request)
    return Record(kind, t0, t1, entry.ops(request), _pbs_rows(counter, kind),
                  request, out.to("cpu"))


def check(enc: lwe.Encoding, big_key, outs: list, expected: list) -> dict:
    """Decrypt every output block with the benchmark's key and compare it
    with the expected value: each request's blocks `outs[i]` [R_i, lwe]
    against `expected[i]` (R_i decoded values).  Returns wrong answers,
    wrong blocks, blocks, and the largest error as a share of the decoding
    margin."""
    import torch

    if not outs:
        raise RuntimeError("no request completed")
    outs_all = torch.cat(list(outs))
    want = torch.tensor([v for e in expected for v in e], dtype=torch.int64)
    if outs_all.shape[0] != want.shape[0]:
        raise RuntimeError(f"{outs_all.shape[0]} output blocks for "
                           f"{want.shape[0]} expected values")
    got, err = lwe.decrypt(enc, big_key.cpu(), outs_all)
    bad = got != want
    wrong_answers, lo = 0, 0
    for e in expected:
        n = len(e)
        wrong_answers += bool(bad[lo:lo + n].any())
        lo += n
    return {"wrong_answers": wrong_answers,
            "wrong_blocks": int(bad.sum()),
            "blocks": int(want.shape[0]),
            "max_error_share": float(err.max())}


def run_cell(bench: Benchmark, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda",
             t_process: Optional[float] = None) -> dict:
    """One run; returns the result object (without printing it)."""
    import torch

    clock = time.perf_counter
    t_process = clock() if t_process is None else t_process
    cell = bench.workload(workload)
    cfg = bench.config(cell["config"])
    traf = bench.traffic(cell["traffic"])
    enc = lwe.Encoding.from_config(cfg["parameters"])
    if device == "cuda":
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats()
    counter = PbsCounter().install()
    try:
        setup = {}
        t = clock()
        small, glwe = lwe.draw_secret_keys(enc, seed, device)
        big_key = glwe.reshape(-1)
        entry = bench.entry(traf["entry"]).Entry(cfg, traf, seed, device,
                                                 enc, small, glwe)
        entry.keygen()
        _sync(device)
        setup["keygen_s"] = clock() - t
        t = clock()
        entry.prepare()
        _sync(device)
        setup["inputs_s"] = clock() - t
        t = clock()
        for kind, rng in traffic_gen.requests(
                dict(traf, order="fixed_rounds"), seed, "warmup",
                rounds=int(traf["warmup_rounds"])):
            entry.submit(entry.make(kind, rng))
            _sync(device)
        setup["warmup_s"] = clock() - t

        stream = traffic_gen.requests(traf, seed, "window")
        records = []
        t_first = clock()
        setup["setup_s"] = t_first - t_process
        deadline = t_first + seconds
        while not records or records[-1].t1 < deadline:
            records.append(_serve(entry, counter,
                                  entry.make(*next(stream)), device, clock))
        window_s = records[-1].t1 - t_first
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0

        run = Run(workload, cfg, traf, setup, records, window_s, peak)
        prof = None
        if trace:
            prof = _traced_slice(entry, counter, seed, device, clock, run)
        done = records + run.traced
        expected = [entry.answer(r.request) for r in done]
        entry.close()
        del entry
        if device == "cuda":
            torch.cuda.empty_cache()
        if prof is not None:
            from .devtrace import summarize
            from .roofline import device_peaks
            run.trace = summarize(prof)
            run.peaks = device_peaks() if device == "cuda" else None
        checks = check(enc, big_key, [r.out for r in done], expected)
    finally:
        counter.uninstall()
    return _result(bench, cell, run, checks, device)


def _traced_slice(entry, counter, seed, device, clock, run):
    """One round of the mix after the window, every kind once, under
    torch.profiler: each request in a `request:<kind>` span and the
    harness's steps in `glue:` spans.  A whole round, from a stream of its
    own, so that every seed traces the same work."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function("bench:traced"):
            for kind, rng in traffic_gen.requests(run.traffic, seed, "trace",
                                                  rounds=1):
                with record_function("glue:make"):
                    req = entry.make(kind, rng)
                counter.begin()
                t0 = clock()
                with record_function(f"request:{entry.kind(req)}"):
                    out = entry.submit(req)
                with record_function("glue:sync"):
                    _sync(device)
                t1 = clock()
                with record_function("glue:copy_out"):
                    host = out.to("cpu")
                kind = entry.kind(req)
                run.traced.append(Record(kind, t0, t1, entry.ops(req),
                                         _pbs_rows(counter, kind), req, host))
    return prof


def _result(bench, cell, run: Run, checks: dict, device: str) -> dict:
    import torch

    kind = "per_layer" if run.trace is not None else "end_to_end"
    metrics = {}
    for m in bench.metrics(cell["name"], kind):
        value = bench.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    n_req = len(run.records) + len(run.traced)
    correct = checks["wrong_answers"] == 0 and checks["wrong_blocks"] == 0
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else device),
           "count": int(cell["chips"]),
           "memory_peak_bytes": int(run.peak_bytes)}
    out = {"correct": correct, "attempted": n_req,
           "failed": checks["wrong_answers"], "metrics": metrics,
           "device": dev,
           "info": {"max_error_share": checks["max_error_share"],
                    "blocks_checked": checks["blocks"],
                    "requests_in_window": len(run.records),
                    "window_s": run.window_s, "setup": run.setup}}
    if run.trace is not None:
        dev["busy_s"] = run.trace["busy_s"]
        dev["window_s"] = run.trace["window_s"]
        out["breakdown"] = {"device_ops": run.trace["device_ops"],
                            "idle_gaps": run.trace["idle_gaps"]}
        out["peaks"] = run.peaks
        out["info"]["trace_events"] = run.trace["event_kinds"]
    out["checks"] = {"wrong_answers": {"value": checks["wrong_answers"],
                                       "limit": 0},
                     "wrong_blocks": {"value": checks["wrong_blocks"],
                                      "limit": 0}}
    return out
