"""128-bit-torus client-side crypto: LWE/GLWE encryption and decryption and
bootstrap-key generation over the u128 torus.

Port of `tfhe_tpu/core/u128_crypto.py` (ref: tfhe/src/core_crypto/
fft_impl/fft128_u128/ and the u128 CiphertextModulus paths of
lwe_encryption.rs / ggsw_encryption.rs).  Words are int64 (lo, hi) pairs
(`ops/u128.py`).  Mask and noise bytes come from the same generators, in
the same order and through the same fork tree as the reference's, so the
same seeds give the same keys and ciphertexts word for word.

The reference multiplies a mask polynomial by the binary key in Python
integers, about N * |s| updates a product, which is hours at N = 2048 for
a whole bootstrap key.  Here every product of one batch is one float64
matrix product of the masks' four 32-bit planes with the key's negacyclic
+-1/0 matrix: each term is a 32-bit integer times -1, 0 or 1 and every
partial sum an integer below k * N * 2^32 <= 2^44 < 2^53, so float64 holds
each of them exactly, in any order of summation; the four plane sums are
then joined with their carries mod 2^128.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops import u128
from ..prng.generators import EncryptionRandomGenerator, SecretRandomGenerator
from .secret import binary_ext_matrix

MOD = 1 << 128


def generate_binary_lwe_secret_key_u128(n: int, gen: SecretRandomGenerator,
                                        device="cuda") -> torch.Tensor:
    """[n] int64 key bits (0/1) on `device`."""
    return torch.from_numpy(gen.random_binary(n).astype(np.int64)).to(
        resolve_device(device))


def glwe_phase_u128(s_bits: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """sum_r mask_r * s_r over Z_{2^128}[X]/(X^N + 1), exactly.

    s_bits [k, N] 0/1, masks [..., k, N, 2] -> [..., N, 2]."""
    k, N = s_bits.shape
    lead = masks.shape[:-3]
    planes = u128.to_planes32(masks)  # [..., k, 4, N]
    a = planes.transpose(-3, -2).reshape(-1, k * N).to(torch.float64)
    smat = binary_ext_matrix(s_bits).reshape(k * N, N).to(torch.float64)
    sums = (a @ smat).to(torch.int64).reshape(*lead, 4, N)
    return u128.from_signed_planes(sums)


def negacyclic_mul_binary(mask: torch.Tensor,
                          s_bits: torch.Tensor) -> torch.Tensor:
    """mask [..., N, 2] * s mod (X^N + 1, 2^128) for a binary s [N]: the
    vectorised `_negacyclic_mul_binary` (tfhe_tpu/core/u128_crypto.py:34)."""
    return glwe_phase_u128(s_bits[None], mask.unsqueeze(-3))


def _lwe_dot(mask: torch.Tensor, s_bits: torch.Tensor) -> torch.Tensor:
    """<mask, s> mod 2^128: mask [..., n, 2], s [n] 0/1 -> [..., 2]."""
    planes = u128.to_planes32(mask)  # [..., 4, n]
    sums = (planes * s_bits).sum(dim=-1, keepdim=True)  # [..., 4, 1]
    return u128.from_signed_planes(sums)[..., 0, :]


def _as_words(values, device) -> torch.Tensor:
    """Python ints (mod 2^128) -> [n, 2] words on `device`."""
    return u128.to_tensor(u128.np_pack(values), device)


def encrypt_lwe_u128(s_bits: torch.Tensor, encoded, std: float,
                     gen: EncryptionRandomGenerator) -> torch.Tensor:
    """[B] plaintexts (Python ints) -> [B, n+1, 2] ciphertexts on the key's
    device.  Each ciphertext draws its n mask words and then one noise
    value, as the reference's loop does."""
    dev = s_bits.device
    enc = _as_words(encoded, dev)
    B, n = enc.shape[0], s_bits.shape[0]
    mask = u128.to_tensor(gen.random_mask(B * n, bits=128), dev).reshape(
        B, n, 2)
    noise = u128.to_tensor(np.concatenate(
        [gen.random_noise(1, std, bits=128) for _ in range(B)]), dev)
    body = u128.add(u128.add(_lwe_dot(mask, s_bits), enc), noise)
    return torch.cat([mask, body[:, None]], dim=1)


def decrypt_lwe_u128(s_bits: torch.Tensor, ct: torch.Tensor) -> torch.Tensor:
    """[..., n+1, 2] ciphertexts -> [..., 2] phases (still noisy and
    encoded); `u128.np_unpack(u128.to_numpy(...))` gives Python ints."""
    ct = ct.to(s_bits.device)
    return u128.sub(ct[..., -1, :], _lwe_dot(ct[..., :-1, :], s_bits))


def _glwe_bodies(glwe_bits: torch.Tensor, presets: torch.Tensor,
                 masks: torch.Tensor, noises: torch.Tensor) -> torch.Tensor:
    """presets [R, N, 2], masks [R, k, N, 2], noises [R, N, 2] -> the GLWE
    ciphertexts [R, k+1, N, 2]: body = preset + phase + noise."""
    phase = glwe_phase_u128(glwe_bits, masks)
    body = u128.add(u128.add(presets, phase), noises)
    return torch.cat([masks, body[:, None]], dim=1)


def encrypt_glwe_preset_u128(glwe_bits: torch.Tensor, body_preset, std: float,
                             gen: EncryptionRandomGenerator) -> torch.Tensor:
    """One GLWE with the plaintext already in the body (N Python ints) ->
    [k+1, N, 2]."""
    dev = glwe_bits.device
    k, N = glwe_bits.shape
    mask = u128.to_tensor(gen.random_mask(k * N, bits=128), dev).reshape(
        1, k, N, 2)
    noise = u128.to_tensor(gen.random_noise(N, std, bits=128), dev)
    return _glwe_bodies(glwe_bits, _as_words(body_preset, dev)[None], mask,
                        noise[None])[0]


def decrypt_glwe_u128(glwe_bits: torch.Tensor,
                      ct: torch.Tensor) -> torch.Tensor:
    """[..., k+1, N, 2] -> [..., N, 2] phase polynomials."""
    ct = ct.to(glwe_bits.device)
    return u128.sub(ct[..., -1, :, :],
                    glwe_phase_u128(glwe_bits, ct[..., :-1, :, :]))


def generate_bootstrap_key_u128(lwe_bits: torch.Tensor,
                                glwe_bits: torch.Tensor, base_log: int,
                                levels: int, std: float,
                                gen: EncryptionRandomGenerator
                                ) -> torch.Tensor:
    """Standard-domain u128 BSK [n, levels, G, G, N, 2] on the GLWE key's
    device (tfhe_tpu/core/u128_crypto.py:105-133): GGSW i encrypts
    lwe_bits[i]; level j's row r < k presets factor * s_r, the last row
    -factor at X^0, factor = -m * 2^(128 - base_log * (j + 1)).  Mask and
    noise bytes are drawn on the host through the fork tree; every row's
    arithmetic runs in one batch on the device."""
    dev = glwe_bits.device
    n = lwe_bits.shape[0]
    k, N = glwe_bits.shape
    G = k + 1
    masks = np.empty((n, levels, G, k * N, 2), dtype=np.uint64)
    noises = np.empty((n, levels, G, N, 2), dtype=np.uint64)
    m_bits = lwe_bits.cpu().numpy()
    factors = [[(-int(m_bits[i]) << (128 - base_log * (j + 1))) % MOD
                for j in range(levels)] for i in range(n)]
    for i, child in enumerate(gen.fork_bsk_to_ggsw(n, levels, G, N,
                                                   bits=128)):
        for j, genl in enumerate(child.fork_ggsw_to_ggsw_levels(
                levels, G, N, bits=128)):
            for r, genr in enumerate(genl.fork_ggsw_level_to_glwe(
                    G, N, bits=128)):
                masks[i, j, r] = genr.random_mask(k * N, bits=128)
                noises[i, j, r] = genr.random_noise(N, std, bits=128)
    factor = u128.to_tensor(u128.np_pack(
        [f for row in factors for f in row]), dev).reshape(n, levels, 1, 1, 2)
    presets = torch.zeros((n, levels, G, N, 2), dtype=torch.int64,
                          device=dev)
    presets[:, :, :k] = torch.where(glwe_bits[..., None] == 1, factor,
                                    torch.zeros_like(factor))
    presets[:, :, k, 0] = u128.neg(factor[:, :, 0, 0])
    rows = _glwe_bodies(
        glwe_bits, presets.reshape(-1, N, 2),
        u128.to_tensor(masks, dev).reshape(-1, k, N, 2),
        u128.to_tensor(noises, dev).reshape(-1, N, 2))
    return rows.reshape(n, levels, G, G, N, 2)
