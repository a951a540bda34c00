"""LWE public keys: standard (zero-encryption list) and compact (Joye-style).

Port of `tfhe_tpu/core/public_key.py`:
- standard: pk = list of encryptions of zero; encrypting adds a random
  binary subset of them and the encoded plaintext on the body
  (ref: algorithms/lwe_public_key_generation.rs:17-41,
   lwe_encryption.rs:914-965 encrypt_lwe_ciphertext_with_public_key);
- compact: pk = one (mask, body) pair of length n related by a
  "semi-reverse" negacyclic convolution with the secret key; a batch of M
  messages compresses to ceil(M/n) masks + M bodies, expanded to full LWE
  ciphertexts by negacyclic monomial rotations
  (ref: algorithms/lwe_compact_public_key_generation.rs:15-51,
   lwe_encryption.rs:1684-1750 and :1837+,
   lwe_compact_ciphertext_list_expansion.rs:12-59).

Every tensor lives on the key's device.  A batch's standard encryption is
one int8 limb product of its [B, count] binary choices with the key's
limbs (`ops.limbs.digits_times_key`), never a [B, count, n+1] broadcast;
a negacyclic product with a binary operand is the GLWE phase's int8 product
(`secret.glwe_phase`).  Randomness is drawn on the host in the reference's
order.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch

from ..ops import limbs, polymul
from ..ops.torus import to_tensor, wrap
from ..prng import sampling
from ..prng.generators import EncryptionRandomGenerator, SecretRandomGenerator
from ..prng.stream import AesCtrStream
from .encrypt import encrypt_lwe
from .secret import LweSecretKey, glwe_phase


def _as_torus(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64)
    return to_tensor(x, device)


def public_key_zero_encryption_count(lwe_size: int, bits: int = 64) -> int:
    """(n + 1) * log2(q) + 128 (ref: shortint/engine/public_side.rs:13-20)."""
    return lwe_size * bits + 128


def negacyclic_mul(a: torch.Tensor, b: torch.Tensor,
                   bits: int = 64) -> torch.Tensor:
    """c = a * b in Z_q[X]/(X^n + 1), exact wrap-around arithmetic: the
    [n, n] products (int64 multiplies wrap mod 2^64), signed and summed
    into their coefficients (ref: polynomial_algorithms.rs
    polynomial_wrapping_add_mul_assign)."""
    n = a.shape[0]
    prod = a[:, None] * b[None, :]
    i = torch.arange(n, device=a.device)
    ij = i[:, None] + i[None, :]
    prod = torch.where(ij >= n, -prod, prod)
    acc = torch.zeros(n, dtype=torch.int64, device=a.device)
    acc.index_add_(0, (ij % n).reshape(-1), prod.reshape(-1))
    return wrap(acc, bits)


def semi_reverse_negacyclic_conv(lhs: torch.Tensor, rhs: torch.Tensor,
                                 bits: int = 64) -> torch.Tensor:
    """out = lhs * phi_1(rhs) in X^n+1, phi_1 = coefficient reversal
    (ref: slice_algorithms.rs:621-659)."""
    return negacyclic_mul(lhs, torch.flip(rhs, dims=[0]), bits=bits)


def _binary_semi_reverse_conv(words: torch.Tensor, binary: torch.Tensor,
                              bits: int) -> torch.Tensor:
    """semi_reverse_negacyclic_conv(words, binary) for a 0/1 polynomial
    `binary`, as one int8 product (the GLWE phase of `words` under the
    reversed binary polynomial)."""
    return glwe_phase(torch.flip(binary, dims=[0])[None], words[None],
                      bits=bits)


def monic_monomial_mul(p: torch.Tensor, degree: int,
                       bits: int = 64) -> torch.Tensor:
    """p * X^degree negacyclically (ref: polynomial_algorithms.rs
    polynomial_wrapping_monic_monomial_mul_assign)."""
    return polymul.monomial_mul(p, degree, p.shape[-1], bits=bits)


# ---------------------------------------------------------------------------
# standard public key
# ---------------------------------------------------------------------------


@dataclass
class LwePublicKey:
    """zero_encs [count, n+1]: encryptions of zero under the secret key.
    Its int8 limb matrix is made at the first encryption and kept."""

    zero_encs: torch.Tensor
    bits: int = 64
    _matrix: Optional[torch.Tensor] = field(default=None, repr=False,
                                            compare=False)

    @property
    def lwe_dimension(self) -> int:
        return self.zero_encs.shape[-1] - 1

    @property
    def zero_encryption_count(self) -> int:
        return self.zero_encs.shape[0]

    def limb_matrix(self) -> torch.Tensor:
        if self._matrix is None:
            self._matrix = limbs.key_limb_matrix(self.zero_encs, self.bits)
        return self._matrix


def generate_lwe_public_key(sk: LweSecretKey, zero_encryption_count: int,
                            std: float,
                            gen: EncryptionRandomGenerator) -> LwePublicKey:
    zeros = torch.zeros(zero_encryption_count, dtype=torch.int64,
                        device=sk.bits_array.device)
    return LwePublicKey(zero_encs=encrypt_lwe(sk, zeros, std, gen),
                        bits=sk.bits)


def encrypt_lwe_with_public_key(pk: LwePublicKey, encoded,
                                secret_gen: SecretRandomGenerator
                                ) -> torch.Tensor:
    """Batch public-key encryption: [B] encoded -> [B, n+1].

    Each ciphertext sums a fresh uniform-binary subset of the zero
    encryptions (ciphertext by ciphertext from `secret_gen`, as the
    reference draws them), then adds the encoded plaintext to the body
    (ref: lwe_encryption.rs:914-965): one int8 product of the [B, count]
    choices with the key's limbs."""
    dev = pk.zero_encs.device
    encoded = _as_torus(encoded, dev)
    B = encoded.shape[0]
    count = pk.zero_encryption_count
    choice = to_tensor(secret_gen.random_binary(B * count), dev).reshape(
        B, count)
    out = limbs.digits_times_key(choice, 1, pk.limb_matrix(), pk.bits)
    out[:, -1] = wrap(out[:, -1] + encoded, pk.bits)
    return out


@dataclass
class SeededLwePublicKey:
    """Compressed standard PK: bodies only + the public mask seed
    (ref: entities/seeded_lwe_public_key.rs,
    algorithms/seeded_lwe_public_key_decompression.rs)."""

    bodies: torch.Tensor  # [count]
    mask_seed: int
    lwe_dimension: int
    bits: int = 64


def generate_seeded_lwe_public_key(sk: LweSecretKey,
                                   zero_encryption_count: int, std: float,
                                   seeder) -> SeededLwePublicKey:
    from .seeded import encrypt_seeded_lwe

    mask_seed = seeder.seed()
    gen = EncryptionRandomGenerator(mask_seed, seeder)
    zeros = torch.zeros(zero_encryption_count, dtype=torch.int64,
                        device=sk.bits_array.device)
    seeded = encrypt_seeded_lwe(sk, zeros, std, mask_seed, gen)
    return SeededLwePublicKey(bodies=seeded.bodies, mask_seed=mask_seed,
                              lwe_dimension=sk.lwe_dimension, bits=sk.bits)


def decompress_lwe_public_key(seeded: SeededLwePublicKey) -> LwePublicKey:
    from .seeded import SeededLweBatch, decompress_seeded_lwe

    full = decompress_seeded_lwe(SeededLweBatch(
        bodies=seeded.bodies, mask_seed=seeded.mask_seed,
        lwe_dimension=seeded.lwe_dimension, bits=seeded.bits))
    return LwePublicKey(zero_encs=full, bits=seeded.bits)


# ---------------------------------------------------------------------------
# compact public key
# ---------------------------------------------------------------------------


@dataclass
class LweCompactPublicKey:
    """mask [n], body [n]: body = semi_rev_conv(mask, s) + e
    (ref: entities/lwe_compact_public_key.rs)."""

    mask: torch.Tensor
    body: torch.Tensor
    bits: int = 64

    @property
    def lwe_dimension(self) -> int:
        return self.mask.shape[0]


@dataclass
class CompactLweCiphertextList:
    """ceil(M/n) masks + M bodies
    (ref: entities/lwe_compact_ciphertext_list.rs)."""

    masks: torch.Tensor   # [n_bins, n]
    bodies: torch.Tensor  # [M]
    bits: int = 64

    @property
    def lwe_dimension(self) -> int:
        return self.masks.shape[-1]

    def __len__(self) -> int:
        return self.bodies.shape[0]


def generate_lwe_compact_public_key(sk: LweSecretKey, std: float,
                                    gen: EncryptionRandomGenerator
                                    ) -> LweCompactPublicKey:
    """(ref: lwe_compact_public_key_generation.rs:15-51)"""
    bits = sk.bits
    dev = sk.bits_array.device
    n = sk.lwe_dimension
    if n & (n - 1):
        raise ValueError(
            "compact public key needs a power-of-two LWE dimension")
    mask = to_tensor(gen.random_mask(n, bits=bits), dev)
    body = _binary_semi_reverse_conv(mask, sk.bits_array, bits)
    body = wrap(body + to_tensor(gen.random_noise(n, std, bits=bits), dev),
                bits)
    return LweCompactPublicKey(mask=mask, body=body, bits=bits)


@dataclass
class SeededLweCompactPublicKey:
    """Compressed compact PK: the mask regenerates from the seed, so only
    the body ships (ref: entities/seeded_lwe_compact_public_key.rs)."""

    body: torch.Tensor
    mask_seed: int
    bits: int = 64


def generate_seeded_lwe_compact_public_key(sk: LweSecretKey, std: float,
                                           seeder
                                           ) -> SeededLweCompactPublicKey:
    mask_seed = seeder.seed()
    gen = EncryptionRandomGenerator(mask_seed, seeder)
    pk = generate_lwe_compact_public_key(sk, std, gen)
    return SeededLweCompactPublicKey(body=pk.body, mask_seed=mask_seed,
                                     bits=sk.bits)


def decompress_lwe_compact_public_key(
        seeded: SeededLweCompactPublicKey) -> LweCompactPublicKey:
    n = seeded.body.shape[0]
    mask = to_tensor(sampling.uniform_torus(AesCtrStream(seeded.mask_seed),
                                            n, bits=seeded.bits),
                     seeded.body.device)
    return LweCompactPublicKey(mask=mask, body=seeded.body, bits=seeded.bits)


def encrypt_compact_lwe_list(pk: LweCompactPublicKey, encoded,
                             mask_std: float, body_std: float,
                             secret_gen: SecretRandomGenerator,
                             enc_gen: EncryptionRandomGenerator
                             ) -> CompactLweCiphertextList:
    """[M] encoded -> compact list with ceil(M/n) mask bins (ref:
    lwe_encryption.rs encrypt_lwe_compact_ciphertext_list_with_compact_
    public_key).  One full-length binary vector per bin; the slots past M
    in the last bin still enter the mask convolution, as in the
    reference."""
    bits = pk.bits
    dev = pk.mask.device
    encoded = _as_torus(encoded, dev)
    M = encoded.shape[0]
    n = pk.lwe_dimension
    n_bins = -(-M // n)
    r = to_tensor(secret_gen.random_binary(n_bins * n), dev).reshape(
        n_bins, n)
    masks, bodies = [], []
    for j in range(n_bins):
        conv_mask = _binary_semi_reverse_conv(pk.mask, r[j], bits)
        masks.append(conv_mask + to_tensor(
            enc_gen.random_noise(n, mask_std, bits=bits), dev))
        conv_body = _binary_semi_reverse_conv(pk.body, r[j], bits)
        lo, hi = j * n, min((j + 1) * n, M)
        bodies.append(conv_body[:hi - lo] + to_tensor(
            enc_gen.random_noise(hi - lo, body_std, bits=bits), dev)
            + encoded[lo:hi])
    return CompactLweCiphertextList(masks=wrap(torch.stack(masks), bits),
                                    bodies=wrap(torch.cat(bodies), bits),
                                    bits=bits)


def expand_compact_lwe_list(compact: CompactLweCiphertextList
                            ) -> torch.Tensor:
    """Compact list -> full [M, n+1] LWE ciphertexts: slot i of a bin takes
    the bin's mask times X^(n-(i+1))
    (ref: lwe_compact_ciphertext_list_expansion.rs:12-59)."""
    n = compact.lwe_dimension
    M = len(compact)
    i = torch.arange(M, device=compact.masks.device)
    masks = polymul.monomial_mul(compact.masks[i // n], n - (i % n + 1), n,
                                 bits=compact.bits)
    return torch.cat([masks, compact.bodies[:, None]], dim=-1)
