"""Registers and spills of every CUDA kernel of the port, as `ptxas -v`
reports them for sm_90a.

Compiles each source of tfhe_tpu_torch/ops/csrc that the port builds, with
the flags it builds them with plus `-Xptxas -v`, all at once, and prints
one JSON object: {source: [{"kernel", "registers", "spill_stores",
"spill_loads", "stack"}, ...]}, each kernel's name demangled where
`c++filt` is found (its template arguments name the variant: `<18, false>`
is the 18-digit form).  Needs nvcc with sm_90a; no card.

    python3 ptxas_report.py > report.json
"""

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

from tfhe_tpu_torch.ops.fused_pbs import NVCC_FLAGS, _nvcc

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "tfhe_tpu_torch", "ops", "csrc")
SOURCES = ("pbs_kernels.cu", "single_cta_kernels.cu", "multibit_kernels.cu",
           "shoup_mac_kernels.cu")

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def parse(text: str) -> list[dict]:
    """The kernels of one `ptxas -v` log, in its order."""
    out, cur = [], None
    for line in text.splitlines():
        if m := _ENTRY.search(line):
            cur = {"kernel": m.group(1)}
        elif cur is not None and (m := _SPILL.search(line)):
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        elif cur is not None and (m := _REGS.search(line)):
            cur["registers"] = int(m.group(1))
            out.append(cur)
            cur = None
    return out


def demangle(names: list[str]) -> list[str]:
    tool = shutil.which("c++filt")
    if tool is None or not names:
        return names
    proc = subprocess.run([tool], input="\n".join(names), capture_output=True,
                          text=True, check=True)
    return proc.stdout.splitlines()


def report(source: str, out_dir: str) -> list[dict]:
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o",
         os.path.join(out_dir, source + ".so"), os.path.join(CSRC, source)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{source}: nvcc failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    kernels = parse(proc.stderr + proc.stdout)
    for k, name in zip(kernels, demangle([k["kernel"] for k in kernels])):
        k["kernel"] = name.split("(")[0].removeprefix("void ")
    return kernels


def main() -> int:
    with tempfile.TemporaryDirectory() as tmp, \
            ThreadPoolExecutor(len(SOURCES)) as pool:
        found = dict(zip(SOURCES, pool.map(lambda s: report(s, tmp),
                                           SOURCES)))
    print(json.dumps(found), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
