"""Radix and CRT big integers over shortint blocks (port of
`tfhe_tpu/integer`; ref: tfhe/src/integer/).  Three schedules: the host
schedule (every op a sequence of shortint batch calls, the same batches as
the reference's), the single-program ops of `fused_dispatch` for clean
inputs (`IntegerServerKey(key, fused=True)`: one CUDA graph replay per op
on a card), and `batched.BatchedRadixOps`, B integers per wave.

`IntegerWopbsKey` evaluates any function of a radix integer by WoPBS
(`integer.wopbs`)."""

from typing import Optional

from ..params import ClassicPBSParameters
from ..shortint import ServerKey as ShortintServerKey
from ..shortint import gen_keys as shortint_gen_keys
from .ciphertext import BooleanBlock, RadixCiphertext
from .client_key import RadixClientKey
from .crt import CrtCiphertext, CrtClientKey, CrtServerKey, gen_keys_crt, i_crt
from .server_key import IntegerServerKey
from .signed import SignedRadixCiphertext
from .wopbs import IntegerWopbsKey, IntegerWopbsLUT


def gen_keys_radix(params: ClassicPBSParameters, num_blocks: int,
                   seed: Optional[int] = None, device="cuda",
                   cache_dir: Optional[str] = None):
    """(ref: tfhe/src/integer/mod.rs:171 gen_keys_radix) -> (RadixClientKey,
    IntegerServerKey) on `device` (the card unless the caller passes
    "cpu"), in the key kind's default blind-rotation schedule and the host
    radix schedule.  Another schedule is a key of its own:
    `IntegerServerKey(shortint.ServerKey(cks.key, mode=...), fused=...)`.
    With `cache_dir` and a seed the raw keys ride the shortint key cache
    (`shortint.gen_keys(cache_dir=)`; ref: integer/keycache.rs)."""
    if cache_dir is not None and seed is not None:
        s_cks, s_sks = shortint_gen_keys(params, seed=seed, device=device,
                                         cache_dir=cache_dir)
        return (RadixClientKey(params, num_blocks, _key=s_cks),
                IntegerServerKey(s_sks))
    cks = RadixClientKey(params, num_blocks, seed=seed, device=device)
    return cks, IntegerServerKey(ShortintServerKey(cks.key))


__all__ = [
    "IntegerWopbsKey",
    "IntegerWopbsLUT",
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
