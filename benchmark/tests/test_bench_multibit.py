"""The multi-bit configuration and its two cells (CPU): both resolve by
name to files of their own; `program.parameters` refuses the
configuration when any stated number differs from the program's; each
cell's entry, at the toy multi-bit set (PARAM_MULTI_BIT_MESSAGE_2_CARRY_2_
GROUP_2_TEST, 8-bit integers) under the cells' own traffic, runs end to end
against the plain reference; the control and each fault (a multi-bit
blind rotation that returns its accumulator unchanged, half a wave left
out, one answer altered) make `correct` false; and the least-work counts
of benchmark/roofline_multibit.py equal hand-worked values at the GROUP_3
widths and do not change with the program's blind-rotation schedule."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from conftest import ROOT

from benchmark import control, harness, program, roofline
from benchmark import roofline_multibit as rm
from benchmark.counters import PbsCounter
from benchmark.reference import lwe

BENCH = harness.Benchmark(ROOT)
CONFIG = "fheuint64_mb3_m2c2"
CELLS = {"u64_mb3_ops_1client": "u64_ops_1client",
         "u64_mb3_batched_b8": "u64_batched_b8"}
METRICS = ["mb_pbs_roofline", "kernels.mb_combine_roofline",
           "kernels.mb_external_product_roofline",
           "core.mb_pbs_batches_per_op", "core.mb_pbs_rows_per_batch",
           "kernels.mb_key_gb_per_op"]
TOY_MB = {
    "name": "PARAM_MULTI_BIT_MESSAGE_2_CARRY_2_GROUP_2_TEST",
    "lwe_dimension": 16, "glwe_dimension": 1, "polynomial_size": 256,
    "lwe_modular_std_dev": 7.069849454709433e-06,
    "glwe_modular_std_dev": 2.9403601535432533e-16,
    "pbs_base_log": 23, "pbs_level": 1, "ks_base_log": 3, "ks_level": 5,
    "message_modulus": 4, "carry_modulus": 4, "grouping_factor": 2,
    "encryption_key_choice": "big", "torus_bits": 64,
}
TOY_CELLS = {"toy_mb_api": "u64_ops_1client",
             "toy_mb_batched": "u64_batched_b8"}
SEED = 2 ** 31 + 77


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_new_cells_resolve_to_files_of_their_own(cell):
    w = BENCH.workload(cell)
    assert (w["config"], w["traffic"], w["chips"]) == (CONFIG, CELLS[cell], 1)
    entry = [c for c in BENCH.spec["configs"] if c["name"] == CONFIG][0]
    assert entry["reduced"] == []
    assert entry["file"] == f"benchmark/configs/{CONFIG}.json"
    cfg = BENCH.config(CONFIG)
    assert (cfg["integer_bits"], cfg["control_bits"]) == (64, 32)
    assert program.parameters(cfg).grouping_factor == 3
    traf = BENCH.traffic(w["traffic"])
    assert traf["entry"] in ("api_ops", "batched_radix")
    names = [m["name"] for m in BENCH.metrics(cell, "per_layer")]
    assert names == METRICS
    for name in names:
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics",
                                           f"{name}.py"))
    e2e = [m["name"] for m in BENCH.metrics(cell, "end_to_end")]
    assert e2e == ["setup_s", "ops_per_s", "peak_mem_mb"]


@pytest.mark.parametrize("key", [k for k, v in TOY_MB.items()
                                 if isinstance(v, (int, float))])
def test_parameters_refuses_a_number_that_differs(key):
    cfg = BENCH.config(CONFIG)
    program.parameters(cfg)
    wrong = json.loads(json.dumps(cfg))
    wrong["parameters"][key] = cfg["parameters"][key] * 2 + 1
    with pytest.raises(ValueError, match=key):
        program.parameters(wrong)


@pytest.fixture
def toy_mb_root(tmp_path):
    """A copy of the benchmark with the toy multi-bit cells added as new
    files and entries, each under the traffic of the cell it stands for."""
    root = str(tmp_path / "checkout")
    os.makedirs(root)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    path = os.path.join(root, "BENCHMARK.json")
    spec = json.load(open(path))
    cfg_file = "benchmark/configs/toy_mb_u8.json"
    with open(os.path.join(root, cfg_file), "w") as fh:
        json.dump({"name": "toy_mb_u8", "parameters": TOY_MB,
                   "integer_bits": 8, "control_bits": 4}, fh)
    spec["configs"].append({"name": "toy_mb_u8", "source": "test",
                            "file": cfg_file, "reduced": [], "why": "test"})
    for cell, traffic in TOY_CELLS.items():
        spec["workloads"].append({"name": cell, "config": "toy_mb_u8",
                                  "traffic": traffic, "chips": 1,
                                  "why": "test"})
    json.dump(spec, open(path, "w"))
    return root


@pytest.mark.parametrize("cell", sorted(TOY_CELLS))
def test_toy_cell_runs_against_the_plain_reference(toy_mb_root, cell):
    torch.set_num_threads(2)
    out = harness.run_cell(harness.Benchmark(toy_mb_root), cell, SEED, 0.5,
                           trace=False, device="cpu")
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert {"setup_s", "ops_per_s"} <= set(out["metrics"])  # no card


@pytest.mark.parametrize("cell", sorted(TOY_CELLS))
def test_control_is_not_correct(toy_mb_root, cell):
    bench = harness.Benchmark(toy_mb_root)
    for seed in (11, 12, SEED):
        r = control.control_readings(bench, cell, seed, 100, "cpu")
        assert r["wrong_answers"] > 0 and r["wrong_blocks"] > 0, r


def _rotation_skipped(monkeypatch):
    """The multi-bit blind rotation returns its accumulator (the LUT
    rotated by the body) with no group step applied."""
    import tfhe_tpu_torch.core.multibit as multibit

    monkeypatch.setattr(multibit, "multi_bit_blind_rotate_cuda",
                        lambda bsk, acc, d_all, mode="scan3": acc)


def _pbs_fault(make):
    def install(monkeypatch):
        import tfhe_tpu_torch.core as core

        orig = core.keyswitch_then_multi_bit_pbs
        monkeypatch.setattr(core, "keyswitch_then_multi_bit_pbs", make(orig))
    return install


def _half(orig):
    def pbs(ksk, bsk, lut, ct_big, mode=None):
        h = (ct_big.shape[0] + 1) // 2
        lut_h = lut[:h] if lut.dim() == 3 else lut
        out = orig(ksk, bsk, lut_h, ct_big[:h], mode)
        return torch.cat([out, out[:ct_big.shape[0] - h]])
    return pbs


def _altered(orig):
    def pbs(ksk, bsk, lut, ct_big, mode=None):
        out = orig(ksk, bsk, lut, ct_big, mode)
        out[0, -1] += 1 << 59  # one more in the message of the first row
        return out
    return pbs


FAULTS = {"rotation_skipped": _rotation_skipped,
          "half_wave": _pbs_fault(_half),
          "altered": _pbs_fault(_altered)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", sorted(TOY_CELLS))
def test_fault_is_not_correct(toy_mb_root, monkeypatch, cell, fault):
    torch.set_num_threads(2)
    FAULTS[fault](monkeypatch)
    out = harness.run_cell(harness.Benchmark(toy_mb_root), cell, SEED, 0.5,
                           trace=False, device="cpu")
    assert out["correct"] is False, out["checks"]


# GROUP_3's widths: G = 2, L = 1, N = 2048, base_log 21, gf = 3
G3 = dict(G=2, L=1, N=2048, base_log=21)
# the least external product: M = 1 plane, P = 4 primes below 2^31
# (20 + 63 + 12 = 95 magnitude bits); a ciphertext's operations:
#   rotate and decompose   G N (10 + 8 L)           =    73_728
#   butterflies x 9        P (LJ + OM) N/2 log N 9  = 1_622_016
#   MAC                    P OM N LJ 7              =   229_376
#   digits mod p           P LJ N 4                 =    65_536
#   CRT                    OM N (6 * 7 + 4 * 10)    =   335_872
EXT_OPS = 2_326_528
# combining 8 subset keys, a ciphertext:
#   spectral     7 (P LJ OM N 9 + P N 2)                    = 2_179_072
#   coefficient  7 (LJ G N 2 + N 2) + P LJ OM N 9
#                + P LJ OM N/2 log N 9                      = 2_060_288
SPECTRAL, COEFFICIENT = 2_179_072, 2_060_288
# bytes: accumulator in and out 2 G N 8 = 65_536 a ciphertext, the mask
# words 3 * 8, the plain group key 8 L G G N 8 = 524_288, the combined
# spectra P LJ OM N 4 = 131_072 a ciphertext
ACC, MASK, KEY, COMBINED = 65_536, 24, 524_288, 131_072


@pytest.mark.parametrize("B", [1, 52, 256])
def test_least_work_equals_the_hand_count(B):
    assert rm.least_plan(**G3) == (4, 1)
    assert roofline.least_step_work(B, **G3)[1] == B * EXT_OPS
    assert rm.combine_ops(B, 3, **G3) == {"spectral": B * SPECTRAL,
                                          "coefficient": B * COEFFICIENT}
    assert rm.group_step_work(B, 3, **G3) == (
        B * (ACC + MASK) + KEY, B * (EXT_OPS + COEFFICIENT))
    assert rm.combine_work(B, 3, **G3) == (
        KEY + B * (MASK + COMBINED), B * COEFFICIENT)
    assert rm.external_product_work(B, **G3) == (
        B * (ACC + COMBINED), B * EXT_OPS)
    p = BENCH.config(CONFIG)["parameters"]
    peak = 1e13
    steps = 888 // 3
    assert rm.batch_min_s("step", B, p, peak) == pytest.approx(
        steps * max((B * (ACC + MASK) + KEY) / roofline.PEAK_BYTES_PER_S,
                    B * (EXT_OPS + COEFFICIENT) / peak))


def test_least_work_does_not_change_with_the_schedule(toy_mb_root):
    """One batched add at the toy set in each blind-rotation schedule:
    the same batches and rows, so the same least time; the combine's key
    bytes move in scan3 alone."""
    from tfhe_tpu_torch.ops import fused_multibit
    from tfhe_tpu_torch.utils import profiling

    torch.set_num_threads(2)
    bench = harness.Benchmark(toy_mb_root)
    cfg = bench.config("toy_mb_u8")
    traf = bench.traffic("u64_batched_b8")
    enc = lwe.Encoding.from_config(cfg["parameters"])
    small, glwe = lwe.draw_secret_keys(enc, SEED, "cpu")
    entry = bench.entry("batched_radix").Entry(cfg, traf, SEED, "cpu", enc,
                                               small, glwe)
    entry.keygen()
    entry.prepare()
    req = entry.make({"op": "add"}, np.random.default_rng(1))
    least, key_bytes = {}, {}
    counter = PbsCounter().install()
    try:
        for mode in fused_multibit.MODES:
            entry.server.mode = mode
            before = profiling.counters()
            counter.begin()
            entry.submit(req)
            rows = counter.end()
            key_bytes[mode] = profiling.changes_since(before).get(
                "fused_multibit.multibit_combine.key_bytes", 0)
            least[mode] = (rows, sum(rm.batch_min_s(
                "step", r, cfg["parameters"], 1e13) for r in rows))
    finally:
        counter.uninstall()
    assert least["scan3"] == least["scan1"] and least["scan3"][1] > 0
    assert key_bytes["scan3"] > 0 and key_bytes["scan1"] == 0


def test_device_trace_metrics_read_the_named_kernels():
    """The three shares on a made-up traced slice at GROUP_3: two batches
    of 52 and 256 rows, K8's two kernels named as the trace names them."""
    p = BENCH.config(CONFIG)["parameters"]
    peak = 16.72704e12
    traced = [harness.Record("add", 0.0, 1.0, 1, [52, 256], {}, None)]
    combine = ("tfhe_pbs::multibit_combine_kernel(int const*, unsigned "
               "int const*)")
    ext = ("void tfhe_core::multibit_step_cluster_kernel<2, true>(long "
           "const*, int const*)")
    k9 = "void tfhe_core::multibit_step_cluster_kernel<2, false>(long const*)"
    trace = {"busy_s": 0.5, "window_s": 0.6,
             "device_ops": [[ext, 0.2], [combine, 0.25], [k9, 1.0]]}
    run = harness.Run("u64_mb3_batched_b8", BENCH.config(CONFIG), {}, {},
                      [], 51.0, 0, traced=traced, trace=trace,
                      peaks={"int32_ops_per_s": peak})

    def least(part):
        return sum(rm.batch_min_s(part, b, p, peak) for b in (52, 256))

    read = {m: BENCH.reader(m)(run) for m in METRICS[:3]}
    assert read["mb_pbs_roofline"] == pytest.approx(
        100 * least("step") / 0.5)
    assert read["kernels.mb_combine_roofline"] == pytest.approx(
        100 * least("combine") / 0.25)
    assert read["kernels.mb_external_product_roofline"] == pytest.approx(
        100 * least("external_product") / 0.2)
    trace["device_ops"] = [[k9, 1.0]]  # another schedule: nothing to read
    assert BENCH.reader("kernels.mb_combine_roofline")(run) is None
    assert BENCH.reader("kernels.mb_external_product_roofline")(run) is None
    classic = BENCH.config("fheuint64_m2c2")
    run.config = classic
    assert all(BENCH.reader(m)(run) is None for m in METRICS[:3])
