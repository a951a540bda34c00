"""The control of a cell's check: the clear function at the precision
below the configuration's (`control_bits`: 32-bit integers for 64-bit
ones, chars compared on 4 bits for 8-bit ones), put in the program's
place.  Its answers are encrypted under the benchmark's key and judged by
the same comparison as a run's outputs, so the check must call them wrong.

    python3 benchmark/control.py --workload <name> --seeds 11 12 13
        --requests <a run's count> [--device cuda|cpu]

Prints one JSON line per seed with the compared numbers.  The benchmark's
own runs never run this.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT


def control_readings(bench, workload: str, seed: int, requests: int,
                     device: str) -> dict:
    """The numbers `harness.check` compares, for `requests` requests of
    the cell's window stream answered by the control."""
    import torch

    from benchmark import harness, traffic
    from benchmark.reference import lwe

    cell = bench.workload(workload)
    cfg = bench.config(cell["config"])
    traf = bench.traffic(cell["traffic"])
    enc = lwe.Encoding.from_config(cfg["parameters"])
    small, glwe = lwe.draw_secret_keys(enc, seed, device)
    big = glwe.reshape(-1)
    entry = bench.entry(traf["entry"]).Entry(cfg, traf, seed, device, enc,
                                             small, glwe)
    g = lwe.generator(seed, 3, device)
    stream = traffic.requests(traf, seed, "window")
    outs, expected = [], []
    for _ in range(requests):
        req = entry.make(*next(stream))
        lower = entry.answer(req, bits=int(cfg["control_bits"]))
        outs.append(lwe.encrypt(enc, big, torch.tensor(lower), g).cpu())
        expected.append(entry.answer(req))
    return harness.check(enc, big, outs, expected)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--requests", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from benchmark import harness

    bench = harness.Benchmark(ROOT)
    for seed in args.seeds:
        r = control_readings(bench, args.workload, seed, args.requests,
                             args.device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "requests": args.requests, **r}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
