"""Key generation: secret keys, bootstrap key, keyswitch key; device prep.

Port of `tfhe_tpu/core/keygen.py`.  The fork tree reproduces the reference's
deterministic parallel keygen (ref: algorithms/lwe_bootstrap_key_generation.rs
+ commons/generators/encryption/mod.rs fork_bsk_to_ggsw): the generator is
forked per GGSW, per level, per row, so key material is a pure function of
the seed.  Mask and noise bytes are drawn on the host in that order; the
heavy arithmetic (every row's GLWE phase, the KSK bodies) runs in a few
batched products on the key's device.  The same seed gives the same bytes as
the reference.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..ops import limbs
from ..ops.torus import to_tensor, wrap
from ..prng.generators import EncryptionRandomGenerator, SecretRandomGenerator
from .secret import GlweSecretKey, LweSecretKey, glwe_phase


def _np_udtype(bits: int):
    return np.uint64 if bits == 64 else np.uint32


def generate_binary_lwe_secret_key(n: int, gen: SecretRandomGenerator,
                                   bits: int = 64,
                                   device="cuda") -> LweSecretKey:
    return LweSecretKey(to_tensor(gen.random_binary(n),
                                  resolve_device(device)), bits=bits)


def generate_binary_glwe_secret_key(k: int, N: int,
                                    gen: SecretRandomGenerator,
                                    bits: int = 64,
                                    device="cuda") -> GlweSecretKey:
    return GlweSecretKey(
        to_tensor(gen.random_binary(k * N), resolve_device(device)).reshape(
            k, N), bits=bits)


def generate_bootstrap_key(lwe_sk: LweSecretKey, glwe_sk: GlweSecretKey,
                           base_log: int, levels: int, noise_std: float,
                           gen: EncryptionRandomGenerator) -> torch.Tensor:
    """Standard-domain BSK: [n_in, levels, G (row j), G (poly o), N] int64.

    ggsw[i] encrypts lwe_sk[i]; level j row r < k presets factor * s_r, the
    last row presets -factor at X^0, factor = -m * 2^(bits - bl*(j+1))
    (ref: ggsw_encryption.rs:72-151, 300-331)."""
    bits = glwe_sk.bits
    dt = _np_udtype(bits)
    dev = glwe_sk.bits_array.device
    n = lwe_sk.lwe_dimension
    k, N = glwe_sk.bits_array.shape
    G = k + 1

    masks = np.empty((n, levels, G, k, N), dtype=dt)
    noises = np.empty((n, levels, G, N), dtype=dt)
    # the preset is -m * 2^(bits - bl*(j+1)) times s_r (rows r < k) or
    # minus that at X^0 (last row); only its scalar factor is per GGSW
    factors = np.empty((n, levels), dtype=dt)
    m_bits = lwe_sk.bits_array.cpu().numpy().astype(dt)

    ggsw_children = gen.fork_bsk_to_ggsw(n, levels, G, N, bits=bits)
    with np.errstate(over="ignore"):
        for i, child in enumerate(ggsw_children):
            lev_children = child.fork_ggsw_to_ggsw_levels(levels, G, N,
                                                          bits=bits)
            for j, genl in enumerate(lev_children):
                factors[i, j] = (dt(0) - m_bits[i]) << dt(
                    bits - base_log * (j + 1))
                row_children = genl.fork_ggsw_level_to_glwe(G, N, bits=bits)
                for r, genr in enumerate(row_children):
                    masks[i, j, r] = genr.random_mask(k * N, bits=bits
                                                      ).reshape(k, N)
                    noises[i, j, r] = genr.random_noise(N, noise_std,
                                                        bits=bits)

    masks_t = to_tensor(masks, dev)
    factor_t = to_tensor(factors, dev)[:, :, None, None]  # [n, L, 1, 1]
    s_polys = glwe_sk.bits_array  # [k, N]
    presets = torch.zeros((n, levels, G, N), dtype=torch.int64, device=dev)
    presets[:, :, :k] = wrap(factor_t * s_polys, bits)
    presets[:, :, k, 0] = wrap(-factor_t[:, :, 0, 0], bits)
    phase = glwe_phase(s_polys, masks_t.reshape(-1, k, N), bits=bits
                       ).reshape(n, levels, G, N)
    bodies = wrap(presets + phase + to_tensor(noises, dev), bits)
    return torch.cat([masks_t, bodies[:, :, :, None, :]], dim=3)


def generate_keyswitch_key(in_sk: LweSecretKey, out_sk: LweSecretKey,
                           base_log: int, levels: int, noise_std: float,
                           gen: EncryptionRandomGenerator) -> torch.Tensor:
    """KSK [n_in, levels, n_out+1] int64; level j encrypts
    s_i * 2^(bits - bl*(j+1)) (ref: lwe_keyswitch_key_generation.rs:343)."""
    bits = in_sk.bits
    dt = _np_udtype(bits)
    dev = out_sk.bits_array.device
    n_in = in_sk.lwe_dimension
    n_out = out_sk.lwe_dimension

    masks = np.empty((n_in, levels, n_out), dtype=dt)
    noises = np.empty((n_in, levels), dtype=dt)
    children = gen.fork_ksk_to_lwe(n_in, levels, n_out, bits=bits)
    for i, child in enumerate(children):
        masks[i] = child.random_mask(levels * n_out, bits=bits).reshape(
            levels, n_out)
        noises[i] = child.random_noise(levels, noise_std, bits=bits)

    masks_t = to_tensor(masks, dev)
    lev_shift = torch.tensor([bits - base_log * (j + 1) for j in range(levels)],
                             dtype=torch.int64, device=dev)
    encoded = in_sk.bits_array.to(dev)[:, None] << lev_shift[None, :]
    body = (masks_t * out_sk.bits_array[None, None, :]).sum(dim=-1)
    body = wrap(body + encoded + to_tensor(noises, dev), bits)
    return torch.cat([masks_t, body[..., None]], dim=-1)


# ---------------------------------------------------------------------------
# device preparation
# ---------------------------------------------------------------------------


@dataclass
class PreparedKsk:
    """KSK as one int8 matrix [n_in * levels, M * (n_out+1)] of limbs, the
    right operand of the keyswitch's int8 product."""

    matrix: torch.Tensor
    base_log: int
    levels: int
    out_dim: int
    bits: int = 64


def prepare_ksk(ksk: torch.Tensor, base_log: int,
                bits: int = 64) -> PreparedKsk:
    """(ref: tfhe_tpu/core/keygen.py:208 prepare_ksk)"""
    n_in, levels, out_size = ksk.shape
    matrix = limbs.key_limb_matrix(ksk.reshape(n_in * levels, out_size), bits)
    return PreparedKsk(matrix=matrix, base_log=base_log, levels=levels,
                       out_dim=out_size - 1, bits=bits)
