"""Encryption random generators and the deterministic fork tree.

Equivalent of the reference's split mask/noise generator pair
(ref: tfhe/src/core_crypto/commons/generators/encryption/mod.rs:24-29) with
the byte-budget fork formulas of mask_random_generator.rs:347-420 and
noise_random_generator.rs:428-500 (copy of `tfhe_tpu/prng/generators.py`,
classic and multi-bit keys).  The fork tree makes key generation
deterministic for a given seed regardless of how the work is parallelized.
"""

from __future__ import annotations

import numpy as np

from .stream import AesCtrStream, Seeder
from . import sampling

# -- byte budgets (ref: mask_random_generator.rs:347+) ----------------------


def mask_bytes_per_coef(bits: int) -> int:
    return bits // 8


def mask_bytes_per_polynomial(bits: int, poly_size: int) -> int:
    return poly_size * mask_bytes_per_coef(bits)


def mask_bytes_per_glwe(bits: int, glwe_dimension: int, poly_size: int) -> int:
    return glwe_dimension * mask_bytes_per_polynomial(bits, poly_size)


def mask_bytes_per_ggsw_level(bits: int, glwe_size: int, poly_size: int) -> int:
    return glwe_size * mask_bytes_per_glwe(bits, glwe_size - 1, poly_size)


def mask_bytes_per_ggsw(bits: int, level: int, glwe_size: int, poly_size: int) -> int:
    return level * mask_bytes_per_ggsw_level(bits, glwe_size, poly_size)


def mask_bytes_per_lwe(bits: int, lwe_dimension: int) -> int:
    return lwe_dimension * mask_bytes_per_coef(bits)


# -- noise byte budgets (ref: noise_random_generator.rs:428+) ---------------


def noise_bytes_per_coef() -> int:
    # f64 sampling needs 4/pi records on average; 32 keeps a safety margin.
    return 8 * 32


def noise_bytes_per_polynomial(poly_size: int) -> int:
    return poly_size * noise_bytes_per_coef()


def noise_bytes_per_glwe(poly_size: int) -> int:
    return noise_bytes_per_polynomial(poly_size)


def noise_bytes_per_ggsw_level(glwe_size: int, poly_size: int) -> int:
    return glwe_size * noise_bytes_per_glwe(poly_size)


def noise_bytes_per_ggsw(level: int, glwe_size: int, poly_size: int) -> int:
    return level * noise_bytes_per_ggsw_level(glwe_size, poly_size)


def noise_bytes_per_lwe() -> int:
    return noise_bytes_per_coef() * 3


# ---------------------------------------------------------------------------


class SecretRandomGenerator:
    """Uniform-binary secret key bits (ref: generators/secret.rs)."""

    def __init__(self, seed: int):
        self._stream = AesCtrStream(seed)

    def random_binary(self, n: int) -> np.ndarray:
        return sampling.uniform_binary(self._stream, n)


class EncryptionRandomGenerator:
    """Paired mask (public-seedable) and noise (secret) generators."""

    def __init__(self, mask_seed: int, seeder: Seeder):
        self.mask = AesCtrStream(mask_seed)
        self.noise = AesCtrStream(seeder.seed())

    @classmethod
    def _from_streams(cls, mask: AesCtrStream, noise: AesCtrStream):
        self = cls.__new__(cls)
        self.mask = mask
        self.noise = noise
        return self

    # -- sampling ----------------------------------------------------------

    def random_mask(self, n: int, bits: int = 64) -> np.ndarray:
        return sampling.uniform_torus(self.mask, n, bits=bits)

    def random_noise(self, n: int, std: float, bits: int = 64) -> np.ndarray:
        return sampling.gaussian_noise_torus(self.noise, n, std, bits=bits)

    # -- forking -----------------------------------------------------------

    def fork(self, n_children: int, mask_bytes: int, noise_bytes: int):
        mask_children = self.mask.try_fork(n_children, mask_bytes)
        noise_children = self.noise.try_fork(n_children, noise_bytes)
        return [
            EncryptionRandomGenerator._from_streams(m, n)
            for m, n in zip(mask_children, noise_children)
        ]

    def fork_bsk_to_ggsw(self, lwe_dimension: int, level: int, glwe_size: int,
                         poly_size: int, bits: int = 64):
        """One child per GGSW of a bootstrap key
        (ref: encryption/mod.rs fork_bsk_to_ggsw)."""
        return self.fork(
            lwe_dimension,
            mask_bytes_per_ggsw(bits, level, glwe_size, poly_size),
            noise_bytes_per_ggsw(level, glwe_size, poly_size),
        )

    def fork_ggsw_to_ggsw_levels(self, level: int, glwe_size: int,
                                 poly_size: int, bits: int = 64):
        return self.fork(
            level,
            mask_bytes_per_ggsw_level(bits, glwe_size, poly_size),
            noise_bytes_per_ggsw_level(glwe_size, poly_size),
        )

    def fork_ggsw_level_to_glwe(self, glwe_size: int, poly_size: int,
                                bits: int = 64):
        return self.fork(
            glwe_size,
            mask_bytes_per_glwe(bits, glwe_size - 1, poly_size),
            noise_bytes_per_glwe(poly_size),
        )

    def fork_multi_bit_bsk_to_ggsw_group(self, lwe_dimension: int, level: int,
                                         glwe_size: int, poly_size: int,
                                         grouping_factor: int, bits: int = 64):
        """One child per group of `grouping_factor` input bits; each group
        holds 2^gf GGSWs (ref: encryption/mod.rs
        fork_multi_bit_bsk_to_ggsw_group)."""
        ggsw_per_element = 1 << grouping_factor
        return self.fork(
            lwe_dimension // grouping_factor,
            ggsw_per_element * mask_bytes_per_ggsw(bits, level, glwe_size,
                                                   poly_size),
            ggsw_per_element * noise_bytes_per_ggsw(level, glwe_size,
                                                    poly_size),
        )

    def fork_multi_bit_bsk_ggsw_group_to_ggsw(self, level: int,
                                              glwe_size: int, poly_size: int,
                                              grouping_factor: int,
                                              bits: int = 64):
        return self.fork(
            1 << grouping_factor,
            mask_bytes_per_ggsw(bits, level, glwe_size, poly_size),
            noise_bytes_per_ggsw(level, glwe_size, poly_size),
        )

    def fork_ksk_to_lwe(self, n_in: int, level: int, lwe_out_dimension: int,
                        bits: int = 64):
        """One child per input-key bit of a keyswitch key (level LWEs each)."""
        return self.fork(
            n_in,
            level * mask_bytes_per_lwe(bits, lwe_out_dimension),
            level * noise_bytes_per_lwe(),
        )
