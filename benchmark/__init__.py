"""The benchmark of `tfhe_tpu_torch` on one NVIDIA card (see README.md)."""
