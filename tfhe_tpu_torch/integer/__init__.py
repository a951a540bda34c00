"""Radix and CRT big integers over shortint blocks (port of
`tfhe_tpu/integer`; ref: tfhe/src/integer/).  Three schedules: the host
schedule (every op a sequence of shortint batch calls, the same batches as
the reference's), the single-program ops of `fused_dispatch` for clean
inputs (`IntegerServerKey(key, fused=True)`: one CUDA graph replay per op
on a card), and `batched.BatchedRadixOps`, B integers per wave.

`IntegerWopbsKey` and `IntegerWopbsLUT` wait for the port of
`core/wopbs.py`; the reference's on-disk key cache has no counterpart
(nothing is written to disk)."""

from typing import Optional

from ..params import ClassicPBSParameters
from ..shortint import ServerKey as ShortintServerKey
from .ciphertext import BooleanBlock, RadixCiphertext
from .client_key import RadixClientKey
from .crt import CrtCiphertext, CrtClientKey, CrtServerKey, gen_keys_crt, i_crt
from .server_key import IntegerServerKey
from .signed import SignedRadixCiphertext


def gen_keys_radix(params: ClassicPBSParameters, num_blocks: int,
                   seed: Optional[int] = None, device="cuda"):
    """(ref: tfhe/src/integer/mod.rs:171 gen_keys_radix) -> (RadixClientKey,
    IntegerServerKey) on `device` (the card unless the caller passes
    "cpu"), in the key kind's default blind-rotation schedule and the host
    radix schedule.  Another schedule is a key of its own:
    `IntegerServerKey(shortint.ServerKey(cks.key, mode=...), fused=...)`."""
    cks = RadixClientKey(params, num_blocks, seed=seed, device=device)
    return cks, IntegerServerKey(ShortintServerKey(cks.key))


__all__ = [
    "CrtCiphertext",
    "CrtClientKey",
    "CrtServerKey",
    "gen_keys_crt",
    "i_crt",
    "RadixCiphertext",
    "SignedRadixCiphertext",
    "BooleanBlock",
    "RadixClientKey",
    "IntegerServerKey",
    "gen_keys_radix",
]
