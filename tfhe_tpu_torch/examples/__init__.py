"""Example applications built on the port's scheme layers (port of
`tfhe_tpu/examples`; ref: tfhe/examples/ — sha256_bool, dark_market,
regex_engine, fhe_strings): gate batches over whole bit-vectors and radix
ops over whole block tensors, every gate or PBS batch one keyswitch + PBS
on the key's device.  Ciphertext words stay tensors on that device; only
what the caller decrypts comes back to the host.
"""
