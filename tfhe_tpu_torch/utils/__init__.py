"""Utilities (port of `tfhe_tpu/utils`): for now only the errors of the
serialization layer, which the ciphertexts' conformance checks raise.  The
wire format, the key cache and the safe (de)serialization wait for ROADMAP
A.6."""
