"""Fixtures of the benchmark's CPU tests: a copy of the benchmark with toy
cells (the test parameter set, 8-bit integers, short strings) added as
files and entries, as a later change would add them."""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TOY_PARAMETERS = {
    "name": "PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST",
    "lwe_dimension": 16, "glwe_dimension": 1, "polynomial_size": 256,
    "lwe_modular_std_dev": 7.069849454709433e-06,
    "glwe_modular_std_dev": 2.9403601535432533e-16,
    "pbs_base_log": 23, "pbs_level": 1, "ks_base_log": 3, "ks_level": 5,
    "message_modulus": 4, "carry_modulus": 4,
    "encryption_key_choice": "big", "torus_bits": 64,
}

TOY_CELLS = {
    # cell: (config name, config body, traffic body)
    "toy_api": ("toy_u8", {"integer_bits": 8, "control_bits": 4}, {
        "entry": "api_ops", "fused": True,
        "pool": {"integers": 4, "booleans": 2},
        "mix": [{"op": "add"}, {"op": "lt"}, {"op": "if_then_else"}],
        "order": "shuffled_rounds", "warmup_rounds": 1}),
    "toy_batched": ("toy_u8", {"integer_bits": 8, "control_bits": 4}, {
        "entry": "batched_radix", "batch": 2,
        "pool": {"integers": 4},
        "mix": [{"op": "add"}, {"op": "eq"}, {"op": "sub"}, {"op": "lt"}],
        "order": "fixed_rounds", "warmup_rounds": 1}),
    "toy_strings": ("toy_strings", {"blocks_per_char": 4, "char_bits": 8,
                                    "max_len": 8, "control_bits": 4}, {
        "entry": "batched_strings", "batch": 4, "text_len": [2, 8],
        "pattern_from_text": 0.5, "pool": {"texts": 8},
        "mix": [{"op": "contains", "pattern_len": 2},
                {"op": "find", "pattern_len": 2}],
        "order": "fixed_rounds", "warmup_rounds": 1}),
}


def add_toy_cells(root: str) -> None:
    """Add the toy cells to the benchmark at `root` as new files and new
    entries of its BENCHMARK.json."""
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as fh:
        spec = json.load(fh)
    here = os.path.join(root, "benchmark")
    for cell, (config, body, traffic) in TOY_CELLS.items():
        cfg_file = f"benchmark/configs/{config}.json"
        if not any(c["name"] == config for c in spec["configs"]):
            with open(os.path.join(root, cfg_file), "w") as fh:
                json.dump({"name": config, "parameters": TOY_PARAMETERS,
                           **body}, fh)
            spec["configs"].append({"name": config, "source": "test",
                                    "file": cfg_file, "reduced": [],
                                    "why": "test"})
        with open(os.path.join(here, "traffic", f"{cell}.json"), "w") as fh:
            json.dump(traffic, fh)
        spec["workloads"].append({"name": cell, "config": config,
                                  "traffic": cell, "chips": 1,
                                  "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = m["workloads"] + list(TOY_CELLS)
    with open(path, "w") as fh:
        json.dump(spec, fh)


@pytest.fixture
def toy_root(tmp_path):
    """A copy of BENCHMARK.json and benchmark/ with the toy cells added."""
    root = str(tmp_path / "checkout")
    os.makedirs(root)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    add_toy_cells(root)
    return root
