"""tfhe_tpu_torch: the PyTorch + CUDA port of tfhe_tpu for NVIDIA Hopper.

This port covers shortint (lookup tables, the batch primitives, the degree
and noise guards and every op family, with classic or multi-bit PBS, in
either PBS order), boolean gates (classic PBS in either order, on the
u32 torus) and integer (radix, signed and CRT integers on shortint
blocks, in the host, single-program and batched schedules) and strings
(encrypted ASCII strings on radix integers).
Entry points run on the card (device="cuda") unless the caller passes
device="cpu", which runs the plain PyTorch versions of the kernels.  The
package imports torch and numpy, never JAX or tfhe_tpu.
"""

from . import boolean, integer, params, shortint, strings
from .shortint import ClientKey, ServerKey, gen_keys

__all__ = ["boolean", "integer", "params", "shortint", "strings",
           "ClientKey", "ServerKey", "gen_keys"]
