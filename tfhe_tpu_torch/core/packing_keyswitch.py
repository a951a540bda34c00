"""General LWE -> GLWE packing keyswitch.

Port of `tfhe_tpu/core/packing_keyswitch.py` (ref: tfhe/src/core_crypto/
algorithms/lwe_packing_keyswitch.rs:102-200 and :297; keygen:
lwe_packing_keyswitch_key_generation.rs).

The PKSK block for input key bit i, level j is a GLWE encryption of the
constant polynomial s_i * q/B^(j+1).  Keyswitching one LWE ciphertext:

    out = (0, ..., body at X^0) - sum_i sum_j digit_ij * PKSK[i][j]

and the list-pack variant shifts ciphertext k by X^k before summing, so a
batch of LWE ciphertexts lands in one GLWE with message m_k at coefficient
k.  The digit contraction ("bnl,nlgc->bgc") is one int8 limb product
(`ops.limbs.digits_times_key`), as in the port's keyswitch; the monomial
packing is `ops.polymul.monomial_mul`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import decomposition, limbs, polymul
from ..ops.torus import to_tensor, wrap
from ..prng.generators import EncryptionRandomGenerator
from .secret import GlweSecretKey, LweSecretKey, glwe_phase


def _np_udtype(bits: int):
    return np.uint64 if bits == 64 else np.uint32


def generate_packing_keyswitch_key(
    in_sk: LweSecretKey,
    glwe_sk: GlweSecretKey,
    base_log: int,
    levels: int,
    noise_std: float,
    gen: EncryptionRandomGenerator,
) -> torch.Tensor:
    """PKSK [n_in, levels, G, N] int64: GLWE encryptions of
    s_i * q/B^(j+1), on the GLWE key's device.

    Fork tree: one child per input key bit (as fork_ksk_to_lwe), so the
    words are those of the reference for the same generator."""
    bits = in_sk.bits
    dt = _np_udtype(bits)
    dev = glwe_sk.bits_array.device
    n_in = in_sk.lwe_dimension
    k, N = glwe_sk.bits_array.shape

    masks = np.empty((n_in, levels, k, N), dtype=dt)
    noises = np.empty((n_in, levels, N), dtype=dt)
    children = gen.fork_ksk_to_lwe(n_in, levels, k * N, bits=bits)
    for i, child in enumerate(children):
        masks[i] = child.random_mask(levels * k * N, bits=bits).reshape(
            levels, k, N)
        noises[i] = child.random_noise(levels * N, noise_std,
                                       bits=bits).reshape(levels, N)

    masks_t = to_tensor(masks, dev)
    phase = glwe_phase(glwe_sk.bits_array, masks_t.reshape(-1, k, N),
                       bits=bits).reshape(n_in, levels, N)
    lev_shift = torch.tensor([bits - base_log * (j + 1)
                              for j in range(levels)], dtype=torch.int64,
                             device=dev)
    bodies = phase + to_tensor(noises, dev)
    bodies[:, :, 0] += in_sk.bits_array.to(dev)[:, None] << lev_shift[None]
    return torch.cat([masks_t, wrap(bodies, bits)[:, :, None, :]], dim=2)


def packing_keyswitch(pksk: torch.Tensor, base_log: int, cts: torch.Tensor,
                      bits: int = 64) -> torch.Tensor:
    """LWE list [B, n_in+1] -> one GLWE [G, N] with message k at X^k.

    Also takes a single ciphertext [n_in+1] (message at X^0)."""
    n, L, G, N = pksk.shape
    if cts.dim() == 1:
        cts = cts[None]
    B = cts.shape[0]
    if B > N:
        raise ValueError("cannot pack more ciphertexts than coefficients")
    digits = decomposition.signed_decompose(cts[:, :-1], base_log, L,
                                            bits=bits)  # [B, n, L]
    matrix = limbs.key_limb_matrix(pksk.reshape(n * L, G * N), bits)
    acc = limbs.digits_times_key(digits.reshape(B, n * L), base_log, matrix,
                                 bits).reshape(B, G, N)
    acc = wrap(-acc, bits)
    acc[:, -1, 0] = wrap(acc[:, -1, 0] + cts[:, -1], bits)
    # pack: out = sum_k acc_k * X^k
    shifted = polymul.monomial_mul(
        acc, torch.arange(B, device=acc.device)[:, None], N, bits=bits)
    return wrap(shifted.sum(dim=0), bits)
