"""Run one cell of the benchmark on the card this process is started on.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

Prints the result as one JSON object on the last line of standard output
and the numbers the check compared, each beside its limit, as the last
lines of standard error.  Exits non-zero, printing no result, where no
CUDA card (or fewer than the cell asks for) is present, or where the
process holds JAX or the JAX package once the window has closed.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT  # the checkout's root, not benchmark/, leads the path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import harness

    bench = harness.Benchmark(ROOT)
    cell = bench.workload(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_PROCESS)
    found = harness.forbidden_modules()
    if found:
        print(f"the measured process holds {', '.join(found)}",
              file=sys.stderr)
        return 3
    info = result["info"]
    print(json.dumps({"info": info, "peaks": result.get("peaks")}),
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
