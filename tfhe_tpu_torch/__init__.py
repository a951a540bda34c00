"""tfhe_tpu_torch: the PyTorch + CUDA port of tfhe_tpu for NVIDIA Hopper.

This port covers shortint (lookup tables, the batch primitives, the degree
and noise guards and every op family, with classic or multi-bit PBS, in
either PBS order), boolean gates (classic PBS in either order, on the
u32 torus) and integer (radix, signed and CRT integers on shortint
blocks, in the host, single-program and batched schedules), strings
(encrypted ASCII strings on radix integers), the high-level API's core
(`api`: ConfigBuilder, generate_keys, set_server_key, FheBool, FheUint*,
FheInt*; its 16 names are also reachable here, imported at first use),
the examples and the Trivium app (`examples`, `apps`), the device-mesh
layer (`parallel`: one process a device under torch.distributed, sharded
and block-sharded radix ops, checkpoint and resume) and the utilities
(`utils`: the wire format, the key cache, profiling on torch.profiler).
Entry points run on the card (device="cuda") unless the caller passes
device="cpu", which runs the plain PyTorch versions of the kernels.  The
package imports torch and numpy, never JAX or tfhe_tpu.
"""

from . import boolean, integer, params, shortint, strings
from .shortint import ClientKey, ServerKey, gen_keys

_API_NAMES = (
    "ConfigBuilder",
    "generate_keys",
    "set_server_key",
    "FheBool",
    "FheUint8",
    "FheUint16",
    "FheUint32",
    "FheUint64",
    "FheUint128",
    "FheUint256",
    "FheInt8",
    "FheInt16",
    "FheInt32",
    "FheInt64",
    "FheInt128",
    "FheInt256",
)


def __getattr__(name):
    # the high-level API is imported at first use, as the reference does
    # (tfhe_tpu/__init__.py:48-55)
    if name in _API_NAMES:
        from . import api

        return getattr(api, name)
    raise AttributeError(f"module 'tfhe_tpu_torch' has no attribute {name!r}")


__all__ = ["boolean", "integer", "params", "shortint", "strings",
           "ClientKey", "ServerKey", "gen_keys", *_API_NAMES]
