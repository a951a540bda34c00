"""Seeded (compressed) ciphertexts and keys: store (mask_seed, bodies) only.

Port of `tfhe_tpu/core/seeded.py` (ref: tfhe/src/core_crypto/entities/
seeded_lwe_ciphertext.rs, seeded_lwe_bootstrap_key.rs:201,
algorithms/seeded_*_decompression.rs and lwe_encryption.rs
encrypt_seeded_lwe_ciphertext_*): the uniformly random mask of every
ciphertext is drawn from a public AES-CTR stream named by a compression
seed, so serialized objects need only the bodies, and masks are
regenerated on decompression.

Decompression is one contiguous CSPRNG sweep: the fork tree partitions the
front of the parent stream into contiguous child windows and every mask
child consumes exactly its byte budget (ref: concrete-csprng/src/generators/
aes_ctr/generic.rs try_fork; mask_random_generator.rs:347-420), so a fresh
root stream emits the concatenated masks in generation order.  The sweep
runs on the port's AES-CTR generator on the host; the words then go to the
bodies' device.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.torus import to_tensor, wrap
from ..prng import sampling
from ..prng.generators import EncryptionRandomGenerator
from ..prng.stream import AesCtrStream
from . import keygen as keygen_mod
from .secret import GlweSecretKey, LweSecretKey


def _regen_mask(mask_seed: int, n_words: int, bits: int,
                device) -> torch.Tensor:
    """The full mask region of a fresh compression stream, in one sweep."""
    return to_tensor(sampling.uniform_torus(AesCtrStream(mask_seed), n_words,
                                            bits=bits), device)


# ---------------------------------------------------------------------------
# seeded LWE ciphertext batches
# ---------------------------------------------------------------------------


@dataclass
class SeededLweBatch:
    """Compressed LWE batch: bodies [B] + the public mask seed
    (ref: entities/seeded_lwe_ciphertext_list.rs)."""

    bodies: torch.Tensor
    mask_seed: int
    lwe_dimension: int
    bits: int = 64


def encrypt_seeded_lwe(sk: LweSecretKey, encoded, std: float,
                       mask_seed: int,
                       noise_gen: EncryptionRandomGenerator
                       ) -> SeededLweBatch:
    """Seeded encryption: the mask from the public seed, the noise from the
    secret generator; only the bodies are kept
    (ref: lwe_encryption.rs encrypt_seeded_lwe_ciphertext_list)."""
    bits = sk.bits
    dev = sk.bits_array.device
    encoded = encoded.to(dev) if isinstance(encoded, torch.Tensor) \
        else to_tensor(encoded, dev)
    B = encoded.shape[0]
    n = sk.lwe_dimension
    mask = _regen_mask(mask_seed, B * n, bits, dev).reshape(B, n)
    noise = to_tensor(noise_gen.random_noise(B, std, bits=bits), dev)
    bodies = wrap((mask * sk.bits_array).sum(dim=-1) + encoded + noise, bits)
    return SeededLweBatch(bodies=bodies, mask_seed=mask_seed,
                          lwe_dimension=n, bits=bits)


def decompress_seeded_lwe(seeded: SeededLweBatch) -> torch.Tensor:
    """[B] bodies -> full [B, n+1] ciphertexts on the bodies' device
    (ref: algorithms/seeded_lwe_ciphertext_list_decompression.rs)."""
    B = seeded.bodies.shape[0]
    n = seeded.lwe_dimension
    mask = _regen_mask(seeded.mask_seed, B * n, seeded.bits,
                       seeded.bodies.device).reshape(B, n)
    return torch.cat([mask, seeded.bodies[:, None]], dim=-1)


# ---------------------------------------------------------------------------
# seeded bootstrap / keyswitch keys
# ---------------------------------------------------------------------------


@dataclass
class SeededBootstrapKey:
    """bodies [n, levels, G, N]: the body polynomial of every GGSW row
    (ref: entities/seeded_lwe_bootstrap_key.rs)."""

    bodies: torch.Tensor
    mask_seed: int
    glwe_dimension: int
    base_log: int
    bits: int = 64


@dataclass
class SeededKeyswitchKey:
    """bodies [n_in, levels] (ref: entities/seeded_lwe_keyswitch_key.rs)."""

    bodies: torch.Tensor
    mask_seed: int
    out_dim: int
    base_log: int
    bits: int = 64


def compress_bootstrap_key(bsk: torch.Tensor, mask_seed: int, base_log: int,
                           bits: int = 64) -> SeededBootstrapKey:
    """Strip the masks of a BSK generated under `mask_seed`: the BSK must
    come from `generate_bootstrap_key` with a generator whose mask stream
    was a fresh stream of that seed."""
    k = bsk.shape[2] - 1
    return SeededBootstrapKey(bodies=bsk[:, :, :, k, :].contiguous(),
                              mask_seed=mask_seed, glwe_dimension=k,
                              base_log=base_log, bits=bits)


def decompress_bootstrap_key(seeded: SeededBootstrapKey) -> torch.Tensor:
    """The full [n, L, G, G, N] BSK on the bodies' device
    (ref: algorithms/seeded_lwe_bootstrap_key_decompression.rs)."""
    n, L, G, N = seeded.bodies.shape
    k = seeded.glwe_dimension
    masks = _regen_mask(seeded.mask_seed, n * L * G * k * N, seeded.bits,
                        seeded.bodies.device).reshape(n, L, G, k, N)
    return torch.cat([masks, seeded.bodies[:, :, :, None, :]], dim=3)


def compress_keyswitch_key(ksk: torch.Tensor, mask_seed: int, base_log: int,
                           bits: int = 64) -> SeededKeyswitchKey:
    return SeededKeyswitchKey(bodies=ksk[..., -1].contiguous(),
                              mask_seed=mask_seed, out_dim=ksk.shape[-1] - 1,
                              base_log=base_log, bits=bits)


def decompress_keyswitch_key(seeded: SeededKeyswitchKey) -> torch.Tensor:
    """The full [n_in, levels, n_out+1] KSK on the bodies' device
    (ref: algorithms/seeded_lwe_keyswitch_key_decompression.rs)."""
    n_in, levels = seeded.bodies.shape
    n_out = seeded.out_dim
    masks = _regen_mask(seeded.mask_seed, n_in * levels * n_out, seeded.bits,
                        seeded.bodies.device).reshape(n_in, levels, n_out)
    return torch.cat([masks, seeded.bodies[..., None]], dim=-1)


# ---------------------------------------------------------------------------
# seeded key generation
# ---------------------------------------------------------------------------


def generate_seeded_server_key_material(
    lwe_sk: LweSecretKey,
    glwe_sk: GlweSecretKey,
    pbs_base_log: int,
    pbs_level: int,
    glwe_std: float,
    big_sk: LweSecretKey,
    ks_base_log: int,
    ks_level: int,
    lwe_std: float,
    seeder,
):
    """(SeededBootstrapKey, SeededKeyswitchKey), each key under a fresh
    public mask seed drawn from `seeder`, so its masks sit at the front of
    a fresh stream (ref: lwe_bootstrap_key_generation.rs seeded
    variants)."""
    bits = glwe_sk.bits
    bsk_mask_seed = seeder.seed()
    gen = EncryptionRandomGenerator(bsk_mask_seed, seeder)
    bsk = keygen_mod.generate_bootstrap_key(lwe_sk, glwe_sk, pbs_base_log,
                                            pbs_level, glwe_std, gen)
    seeded_bsk = compress_bootstrap_key(bsk, bsk_mask_seed, pbs_base_log,
                                        bits)
    ksk_mask_seed = seeder.seed()
    gen = EncryptionRandomGenerator(ksk_mask_seed, seeder)
    ksk = keygen_mod.generate_keyswitch_key(big_sk, lwe_sk, ks_base_log,
                                            ks_level, lwe_std, gen)
    seeded_ksk = compress_keyswitch_key(ksk, ksk_mask_seed, ks_base_log,
                                        bits)
    return seeded_bsk, seeded_ksk
