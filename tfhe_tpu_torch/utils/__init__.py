"""Utilities (port of `tfhe_tpu/utils`): the wire format with its size
limit and conformance checks, the key cache, and the profiling helpers
(`trace` and `annotate` on torch.profiler, `OpTimer`).  The reference's
JAX compilation cache has no counterpart: it exists only for JAX's
compiles."""

from .keycache import KEY_CACHE, KeyCache
from .profiling import OpTimer, annotate, trace
from .serialization import (ConformanceError, DeserializationError,
                            deserialize, safe_deserialize, safe_serialize,
                            serialize)

__all__ = [
    "KeyCache",
    "KEY_CACHE",
    "OpTimer",
    "annotate",
    "trace",
    "ConformanceError",
    "DeserializationError",
    "safe_serialize",
    "safe_deserialize",
    "serialize",
    "deserialize",
]
