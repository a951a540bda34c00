"""The serialization layer's errors (port of
`tfhe_tpu/utils/serialization.py:39-46`).

The ciphertexts' `_conformance_check` methods raise `ConformanceError`; the
wire format that also raises them is not ported yet (ROADMAP A.6)."""


class DeserializationError(Exception):
    pass


class ConformanceError(DeserializationError):
    """Decoded object does not match the expected parameter set
    (ref: tfhe/src/conformance.rs ParameterSetConformant)."""
