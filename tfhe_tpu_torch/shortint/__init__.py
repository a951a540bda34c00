"""Shortint: few-bit message+carry integers over the u64 torus
(port of `tfhe_tpu/shortint`; ref: tfhe/src/shortint/)."""

from .ciphertext import CheckError, Ciphertext, ShortintBatch
from .client_key import ClientKey
from .server_key import BivariateLookupTable, LookupTable, ServerKey, gen_keys

__all__ = [
    "CheckError", "Ciphertext", "ShortintBatch", "ClientKey", "ServerKey",
    "LookupTable", "BivariateLookupTable", "gen_keys",
]
