"""Utilities (port of `tfhe_tpu/utils`): the wire format with its size
limit and conformance checks, the key cache, and profiling (the program's
spans and counters, `trace` on torch.profiler, `OpTimer`).  The reference's
JAX compilation cache has no counterpart: it exists only for JAX's
compiles.

`profiling` is imported with the package: the kernels and the core count
into it.  The wire format and the key cache are imported at first use of
one of their names, since the wire format's adapters import the shortint
and integer layers, which import the kernels."""

from .profiling import OpTimer, annotate, trace

_LAZY = {
    "KeyCache": "keycache",
    "KEY_CACHE": "keycache",
    "ConformanceError": "serialization",
    "DeserializationError": "serialization",
    "safe_serialize": "serialization",
    "safe_deserialize": "serialization",
    "serialize": "serialization",
    "deserialize": "serialization",
}

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


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(f".{_LAZY[name]}", __name__),
                       name)
    raise AttributeError(
        f"module 'tfhe_tpu_torch.utils' has no attribute {name!r}")
