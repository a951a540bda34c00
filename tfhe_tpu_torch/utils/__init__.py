"""Utilities (port of `tfhe_tpu/utils`): the wire format with its size
limit and conformance checks, and the key cache.  The reference's JAX
compilation cache and profiling helpers have no counterpart."""

from .keycache import KEY_CACHE, KeyCache
from .serialization import (ConformanceError, DeserializationError,
                            deserialize, safe_deserialize, safe_serialize,
                            serialize)

__all__ = [
    "KeyCache",
    "KEY_CACHE",
    "ConformanceError",
    "DeserializationError",
    "safe_serialize",
    "safe_deserialize",
    "serialize",
    "deserialize",
]
