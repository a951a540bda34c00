"""LWE/GLWE encryption and decryption.

Port of `tfhe_tpu/core/encrypt.py` (ref: tfhe/src/core_crypto/algorithms/
{lwe_encryption.rs, glwe_encryption.rs}: body = <mask, s> + encoded + noise;
native modulus only).  Mask and noise come from the AES-CTR streams on the
host, in the reference's byte order; the arithmetic runs on the key's device.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..ops.torus import to_tensor, wrap
from ..prng.generators import EncryptionRandomGenerator
from .secret import GlweSecretKey, LweSecretKey, glwe_phase


def _as_torus(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64)
    return to_tensor(x, device)


def encrypt_lwe(sk: LweSecretKey, encoded, std: float,
                gen: EncryptionRandomGenerator) -> torch.Tensor:
    """Encrypt a batch of encoded plaintexts: [...] -> [..., n+1].

    Mask and noise bytes are consumed ciphertext by ciphertext, as in
    sequential encryption."""
    bits = sk.bits
    dev = sk.bits_array.device
    encoded = _as_torus(encoded, dev)
    shape = encoded.shape
    B = encoded.numel()
    n = sk.lwe_dimension
    mask = to_tensor(gen.random_mask(B * n, bits=bits), dev).reshape(B, n)
    noise = to_tensor(gen.random_noise(B, std, bits=bits), dev)
    body = (mask * sk.bits_array).sum(dim=-1)
    body = wrap(body + encoded.reshape(B) + noise, bits)
    return torch.cat([mask, body[:, None]], dim=-1).reshape(*shape, n + 1)


def decrypt_lwe(sk: LweSecretKey, ct: torch.Tensor) -> torch.Tensor:
    """Phase of ct [..., n+1] -> [...] (still noisy and encoded)."""
    ct = _as_torus(ct, sk.bits_array.device)
    return wrap(ct[..., -1] - (ct[..., :-1] * sk.bits_array).sum(dim=-1),
                sk.bits)


def trivial_lwe(encoded, lwe_dimension: int, bits: int = 64,
                device="cuda") -> torch.Tensor:
    """(0, ..., 0, encoded): no key, no noise (ref: lwe_encryption.rs
    allocate_and_trivially_encrypt_new_lwe_ciphertext)."""
    encoded = _as_torus(encoded, resolve_device(device))
    out = torch.zeros(*encoded.shape, lwe_dimension + 1, dtype=torch.int64,
                      device=encoded.device)
    out[..., -1] = wrap(encoded, bits)
    return out


def encrypt_glwe_assign(sk: GlweSecretKey, body_preset, std: float,
                        gen: EncryptionRandomGenerator) -> torch.Tensor:
    """GLWE-encrypt with the plaintext already added into the body:
    [..., N] -> [..., k+1, N] (ref: glwe_encryption.rs
    encrypt_glwe_ciphertext_assign)."""
    bits = sk.bits
    dev = sk.bits_array.device
    k, N = sk.bits_array.shape
    body_preset = _as_torus(body_preset, dev)
    shape = body_preset.shape[:-1]
    B = body_preset.numel() // N
    mask = to_tensor(gen.random_mask(B * k * N, bits=bits), dev).reshape(
        B, k, N)
    noise = to_tensor(gen.random_noise(B * N, std, bits=bits), dev).reshape(
        B, N)
    phase = glwe_phase(sk.bits_array, mask, bits=bits)
    body = wrap(body_preset.reshape(B, N) + phase + noise, bits)
    return torch.cat([mask, body[:, None, :]], dim=1).reshape(*shape, k + 1, N)


def decrypt_glwe(sk: GlweSecretKey, ct: torch.Tensor) -> torch.Tensor:
    """Phase polynomials: [..., k+1, N] -> [..., N]."""
    ct = _as_torus(ct, sk.bits_array.device)
    return wrap(ct[..., -1, :] - glwe_phase(sk.bits_array, ct[..., :-1, :],
                                            bits=sk.bits), sk.bits)
