"""Build a shared library from the package's own sources at first use.

Both native parts of the port go through here: the AES-CTR generator
(`prng/csrc/aes_csprng.cpp`, g++) and the blind-rotation kernels
(`ops/csrc/*.cu`, nvcc for sm_90a).  Each library lands in
`tfhe_tpu_torch/_build/<name>-<hash>/`, where the hash covers the sources and
the compiler command, so an edited source or flag builds anew and a stale
library is never loaded.

The build takes no lock: the compiler writes to a name unique to this
process, which is renamed into place when it is complete.  Two processes
building at once both finish, and the second rename replaces the first with
an identical file.  A build that is cut off leaves only the temporary file.
"""

from __future__ import annotations

import hashlib
import os
import subprocess

BUILD_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")


class BuildError(RuntimeError):
    """A native build failed; the message carries the compiler's stderr."""


def build_shared_library(name: str, sources: list[str], command: list[str],
                         timeout: float, headers: tuple[str, ...] = ()) -> str:
    """Compile `sources` with `command + ["-o", <out>] + sources`; return the
    path of the library, building it only if this exact build is missing.
    `headers` are hashed with the sources but not passed to the compiler."""
    digest = hashlib.sha256(" ".join(command).encode())
    for src in list(sources) + list(headers):
        with open(src, "rb") as fh:
            digest.update(fh.read())
    out_dir = os.path.join(BUILD_ROOT, f"{name}-{digest.hexdigest()[:16]}")
    out = os.path.join(out_dir, f"lib{name}.so")
    if os.path.exists(out):
        return out
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run(command + ["-o", tmp] + sources,
                              capture_output=True, text=True, timeout=timeout)
        if proc.returncode != 0:
            raise BuildError(
                f"{name}: {' '.join(command)} failed ({proc.returncode}):\n"
                f"{proc.stderr}")
        os.replace(tmp, out)
    except FileNotFoundError as exc:
        raise BuildError(f"{name}: compiler not found: {exc}") from exc
    except subprocess.TimeoutExpired as exc:
        raise BuildError(f"{name}: build exceeded {timeout} s") from exc
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out
