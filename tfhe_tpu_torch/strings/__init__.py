"""Encrypted ASCII strings (port of `tfhe_tpu/strings`; ref: tfhe/examples/
fhe_strings/), on radix integers of NUMBER_BLOCKS blocks a char."""

from typing import Optional

from ..integer import gen_keys_radix
from ..params import (ClassicPBSParameters,
                      PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST,
                      PARAM_MESSAGE_2_CARRY_2_KS_PBS)
from .ciphertext import FheAsciiChar, FheSplit, FheString, Padding
from .client_key import NUMBER_BLOCKS, ConversionError, StringClientKey
from .server_key import StringServerKey


def gen_keys(params: ClassicPBSParameters = PARAM_MESSAGE_2_CARRY_2_KS_PBS,
             seed: Optional[int] = None, device="cuda",
             cache_dir: Optional[str] = None):
    """(ref: fhe_strings/ciphertext.rs gen_keys) -> (StringClientKey,
    StringServerKey) on `device` (the card unless the caller passes
    "cpu"); `cache_dir` as `shortint.gen_keys`."""
    cks, sks = gen_keys_radix(params, NUMBER_BLOCKS, seed=seed, device=device,
                              cache_dir=cache_dir)
    return StringClientKey(cks), StringServerKey(sks)


def gen_keys_test(seed: Optional[int] = None, device="cuda"):
    """Insecure fast-test keys (ref: ciphertext.rs:93 gen_keys_test)."""
    return gen_keys(PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST, seed=seed,
                    device=device)


__all__ = [
    "FheString",
    "FheSplit",
    "FheAsciiChar",
    "Padding",
    "StringClientKey",
    "StringServerKey",
    "ConversionError",
    "NUMBER_BLOCKS",
    "gen_keys",
    "gen_keys_test",
]
