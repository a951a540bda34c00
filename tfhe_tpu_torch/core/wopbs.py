"""WoPBS: bit extraction, circuit bootstrapping, CMux tree, vertical packing.

Port of `tfhe_tpu/core/wopbs.py` (ref: tfhe/src/core_crypto/fft_impl/fft64/
crypto/wop_pbs/mod.rs — extract_bits :66, circuit_bootstrap_boolean :243,
homomorphic shift, cmux_tree_memory_optimized :468, vertical_packing :785;
PFPKS keys: algorithms/lwe_private_functional_packing_keyswitch_key_
generation.rs and lwe_wopbs.rs generate_circuit_bootstrap_lwe_pfpksk_list
:80-160).

Everything is batched over the ciphertext axis, on the keys' device:
  * bit extraction and the circuit bootstrap's homomorphic shifts run the
    port's keyswitch and classic `programmable_bootstrap`, so on a card each
    PBS is the blind rotation's kernels (K1 + K2 in the default "scan2");
  * the private functional packing keyswitch is one int8 limb product
    (`ops.limbs.digits_times_key`), the reference's "bil,ilgn->bgn" einsum;
  * the CMux tree and the vertical packing's blind rotation take a fresh
    GGSW per input, so its forward NTT happens per call: the external
    product is torch ops on the CRT-NTT pieces of `ops/polymul_ntt.py`
    (decomposition, digit and key spectra, the MAC per prime, inverse NTT,
    CRT), exact, as it is jnp ops in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..ops import decomposition, limbs, polymul
from ..ops.polymul_ntt import (decompose_digits, digit_spectra,
                               inverse_residues, key_to_spectra,
                               residues_to_words)
from ..ops.torus import to_tensor
from ..prng.generators import EncryptionRandomGenerator
from .encrypt import encrypt_glwe_assign
from .keygen import PreparedKsk
from .keyswitch import keyswitch
from .pbs import programmable_bootstrap, sample_extract
from .secret import GlweSecretKey, LweSecretKey


def _i64(x: int) -> int:
    """A u64 constant as the int64 with the same bits."""
    x %= 1 << 64
    return x - (1 << 64) if x >= 1 << 63 else x


# ---------------------------------------------------------------------------
# private functional packing keyswitch (ref: lwe_private_functional_
# packing_keyswitch_key_generation.rs + lwe_private_functional_packing_
# keyswitch.rs:21-85)
# ---------------------------------------------------------------------------


def generate_cbs_pfpksk_list(
    big_lwe_sk: LweSecretKey,
    glwe_sk: GlweSecretKey,
    base_log: int,
    levels: int,
    noise_std: float,
    gen: EncryptionRandomGenerator,
) -> torch.Tensor:
    """[G, n_in+1, levels, G, N] int64: pfpksk o packs into GLWE row o.

    pfpksk o encrypts, for each input key bit s_i (the body slot uses the
    constant -1) and level l, GLWE(poly_o * (-s_i) * 2^(64 - l*base)) where
    poly_o is GLWE key polynomial o for o < k and -X^0 for the body slot
    (ref: lwe_wopbs.rs:80-160).  The reference encrypts the G (n_in+1) lists
    in a loop, each drawing its masks then its noise; the mask and noise
    streams are separate and every list draws an even count of noise
    values, so one batched encryption draws the same words."""
    bits = glwe_sk.bits
    dev = glwe_sk.bits_array.device
    n_in = big_lwe_sk.lwe_dimension
    k, N = glwe_sk.bits_array.shape
    G = k + 1

    polys = torch.zeros((G, N), dtype=torch.int64, device=dev)
    polys[:k] = glwe_sk.bits_array
    polys[k, 0] = -1  # -X^0
    key_bits = torch.cat([big_lwe_sk.bits_array.to(dev),
                          torch.full((1,), -1, dtype=torch.int64,
                                     device=dev)])  # Scalar::MAX == -1
    shifts = torch.tensor([bits - base_log * (l + 1) for l in range(levels)],
                          dtype=torch.int64, device=dev)
    w = -(key_bits[:, None] << shifts[None])  # [n_in+1, levels]
    msgs = polys[:, None, None, :] * w[None, :, :, None]  # [G, n+1, L, N]
    return encrypt_glwe_assign(glwe_sk, msgs, noise_std, gen)


def pfpksk_matrix(pfpksk_o: torch.Tensor) -> torch.Tensor:
    """One row's key [n_in+1, levels, G, N] -> the int8 limb matrix that
    `pfpks_to_glwe` multiplies by."""
    n1, L, G, N = pfpksk_o.shape
    return limbs.key_limb_matrix(pfpksk_o.reshape(n1 * L, G * N))


def pfpks_to_glwe(matrix: torch.Tensor, lwe: torch.Tensor, base_log: int,
                  levels: int, glwe_size: int) -> torch.Tensor:
    """Batched private functional packing keyswitch.

    matrix: `pfpksk_matrix` of one row's key [n_in+1, levels, G, N];
    lwe [B, n_in+1] -> GLWE [B, G, N] = -sum_{i,l} digit_{i,l}(lwe_i) *
    K[i,l] (ref: lwe_private_functional_packing_keyswitch.rs:55-85)."""
    B, n1 = lwe.shape
    digits = decomposition.signed_decompose(lwe, base_log, levels)
    acc = limbs.digits_times_key(digits.reshape(B, n1 * levels), base_log,
                                 matrix)
    return (-acc).reshape(B, glwe_size, matrix.shape[1] // (8 * glwe_size))


# ---------------------------------------------------------------------------
# dynamic-key external product / cmux (NTT, exact)
# ---------------------------------------------------------------------------


def external_product_dynamic(ggsw_std: torch.Tensor, glwe: torch.Tensor,
                             base_log: int, levels: int) -> torch.Tensor:
    """GGSW (x) GLWE with a per-batch standard-domain GGSW.

    ggsw_std: [B, L, J=G, O=G, N] int64; glwe: [B, G, N] int64 -> [B, G, N].
    The GGSW is fresh per input (it came out of circuit bootstrapping), so
    its forward NTT happens here; the digit side is the classic path's
    (ref: fft64/crypto/ggsw.rs add_external_product_assign).  The MAC
    multiplies balanced residues (|x| < 2^16) in int64 and sums the L*G
    products exactly before one reduction per prime."""
    B, L, G, O, N = ggsw_std.shape
    digits = decompose_digits(glwe, base_log, levels)  # [B, L*G, N]
    dspec = digit_spectra(digits).to(torch.int64)  # [P, B, LJ, N]
    kspec, _ = key_to_spectra(ggsw_std)  # [P, B, L, J, O, M, N]
    P, M = kspec.shape[0], kspec.shape[-2]
    kspec = kspec.reshape(P, B, L * G, O * M, N).to(torch.int64)
    prods = (dspec[:, :, :, None, :] * kspec).sum(dim=2)  # [P, B, OM, N]
    res = inverse_residues(prods.permute(1, 2, 0, 3), O, M)
    return residues_to_words(res)


def cmux_dynamic(ct0: torch.Tensor, ct1: torch.Tensor,
                 ggsw_std: torch.Tensor, base_log: int,
                 levels: int) -> torch.Tensor:
    """ct0 + GGSW (x) (ct1 - ct0): ct1 where the GGSW encrypts 1
    (ref: fft64/crypto/ggsw.rs:766-777)."""
    return ct0 + external_product_dynamic(ggsw_std, ct1 - ct0, base_log,
                                          levels)


# ---------------------------------------------------------------------------
# bit extraction (ref: wop_pbs/mod.rs:66-231)
# ---------------------------------------------------------------------------


def _sign_lut(alpha: int, glwe_size: int, N: int,
              device) -> torch.Tensor:
    """The negacyclic sign LUT: -alpha in every body coefficient."""
    acc = torch.zeros((glwe_size, N), dtype=torch.int64, device=device)
    acc[-1, :] = _i64(-alpha)
    return acc


def extract_bits(bsk_prepared, ksk_prepared: PreparedKsk,
                 lwe_in: torch.Tensor, delta_log: int, n_bits: int,
                 mode: Optional[str] = None) -> torch.Tensor:
    """[B, n_big+1] -> [B, n_bits, n_small+1], MSB first.

    Peels the least significant remaining bit: shift it onto the sign
    position, keyswitch down (that is the output bit), then a negacyclic
    sign LUT recovers the bit's torus contribution, which is subtracted
    before the next round.  Extraction runs LSB to MSB; the list is
    reversed so index 0 holds the MSB (ref: wop_pbs/mod.rs:128-130).
    `mode` is the blind rotation's schedule (None: the key's default)."""
    bits = 64
    lwe = lwe_in
    N = bsk_prepared.polynomial_size
    G = bsk_prepared.glwe_size
    outs = []
    for bit_idx in range(n_bits):
        # the bit at position delta_log + bit_idx lands on the sign bit
        shift = bits - delta_log - bit_idx - 1
        ks = keyswitch(ksk_prepared, lwe * _i64(1 << shift))
        outs.append(ks)
        if bit_idx == n_bits - 1:
            break
        # centre the error, then the sign LUT at scale delta_log - 1 + bit_idx
        ks_c = ks.clone()
        ks_c[:, -1] += _i64(1 << (bits - 2))
        alpha = 1 << (delta_log - 1 + bit_idx)
        pbs_out = programmable_bootstrap(
            bsk_prepared, _sign_lut(alpha, G, N, lwe.device), ks_c, mode)
        pbs_out[:, -1] += alpha
        lwe = lwe - pbs_out
    return torch.stack(outs[::-1], dim=1)


# ---------------------------------------------------------------------------
# circuit bootstrapping (ref: wop_pbs/mod.rs:243-360)
# ---------------------------------------------------------------------------


def homomorphic_shift_boolean(bsk_prepared, lwe_in: torch.Tensor,
                              level: int, cbs_base_log: int, delta_log: int,
                              mode: Optional[str] = None) -> torch.Tensor:
    """LWE(b * 2^delta_log) -> LWE(b * 2^(64 - base*level)) by one
    negacyclic PBS (ref: wop_pbs/mod.rs homomorphic_shift_boolean)."""
    bits = 64
    shifted = lwe_in * _i64(1 << (bits - delta_log - 1))
    shifted[:, -1] += _i64(1 << (bits - 2))
    alpha = 1 << (bits - 1 - cbs_base_log * level)
    out = programmable_bootstrap(
        bsk_prepared,
        _sign_lut(alpha, bsk_prepared.glwe_size,
                  bsk_prepared.polynomial_size, lwe_in.device),
        shifted, mode)
    out[:, -1] += alpha
    return out


@dataclass
class CircuitBootstrapper:
    """The keys and decomposition parameters of the CBS pipeline.  The
    pfpksk rows' limb matrices are made once, at construction."""

    bsk_prepared: object          # the PBS key (WoPBS parameters)
    ksk_prepared: PreparedKsk     # big -> small keyswitch
    pfpksk_list: torch.Tensor     # [G, n_in+1, pfks_levels, G, N]
    pfks_base_log: int
    pfks_levels: int
    cbs_base_log: int
    cbs_levels: int
    mode: Optional[str] = None    # the blind rotation's schedule

    def __post_init__(self):
        self._matrices = [pfpksk_matrix(self.pfpksk_list[o])
                          for o in range(self.pfpksk_list.shape[0])]

    def circuit_bootstrap(self, lwe_in: torch.Tensor,
                          delta_log: int) -> torch.Tensor:
        """[B, n_small+1] bit LWEs -> GGSW [B, cbs_levels, G, G, N]."""
        G = self.pfpksk_list.shape[0]
        levels_out = []
        for level in range(1, self.cbs_levels + 1):
            shifted = homomorphic_shift_boolean(
                self.bsk_prepared, lwe_in, level, self.cbs_base_log,
                delta_log, self.mode)  # [B, n_big+1]
            rows = [pfpks_to_glwe(m, shifted, self.pfks_base_log,
                                  self.pfks_levels, G)
                    for m in self._matrices]  # each [B, G, N]
            levels_out.append(torch.stack(rows, dim=1))  # [B, G(row), G, N]
        return torch.stack(levels_out, dim=1)  # [B, L, G, G, N]


# ---------------------------------------------------------------------------
# cmux tree + vertical packing (ref: wop_pbs/mod.rs:468-900)
# ---------------------------------------------------------------------------


def _lut_glwes(luts: torch.Tensor, glwe_size: int, B: int) -> torch.Tensor:
    """Trivial GLWEs of clear polynomials: luts [count, N] -> [count, B, G,
    N]."""
    count, N = luts.shape
    out = torch.zeros((count, B, glwe_size, N), dtype=torch.int64,
                      device=luts.device)
    out[:, :, -1] = luts[:, None]
    return out


def cmux_tree(luts: torch.Tensor, ggsw_bits: List[torch.Tensor],
              glwe_size: int, cbs_base_log: int,
              cbs_levels: int) -> torch.Tensor:
    """luts [count, N] clear polynomials; ggsw_bits: list of
    [B, L, G, G, N] (MSB first), len == log2(count) -> GLWE [B, G, N].

    Layer 0 pairs adjacent LUTs under the last (least significant) tree
    bit, as the reference's memory-optimized tree consumed in reverse
    (ref: wop_pbs/mod.rs:468-560)."""
    B = ggsw_bits[0].shape[0]
    layer = list(_lut_glwes(luts, glwe_size, B))
    for ggsw in reversed(ggsw_bits):
        layer = [cmux_dynamic(layer[i], layer[i + 1], ggsw, cbs_base_log,
                              cbs_levels)
                 for i in range(0, len(layer), 2)]
    if len(layer) != 1:
        raise ValueError("the LUT count must be 2^len(ggsw_bits)")
    return layer[0]


def vp_blind_rotate(glwe: torch.Tensor, ggsw_bits: List[torch.Tensor],
                    cbs_base_log: int, cbs_levels: int) -> torch.Tensor:
    """Blind rotation by the packed value of the remaining (LSB-side) GGSW
    bits: bit j rotates by 2^j through a CMux
    (ref: wop_pbs/mod.rs blind_rotate_assign:740-770)."""
    N = glwe.shape[-1]
    degree = 1
    acc = glwe
    for ggsw in reversed(ggsw_bits):
        rotated = polymul.monomial_div(acc, degree, N)
        acc = cmux_dynamic(acc, rotated, ggsw, cbs_base_log, cbs_levels)
        degree <<= 1
    return acc


def vertical_packing(luts, ggsw_bits: List[torch.Tensor], glwe_size: int,
                     cbs_base_log: int, cbs_levels: int) -> torch.Tensor:
    """luts [count, N] (numpy uint64 or int64 tensor), ggsw_bits MSB first
    -> LWE [B, k*N+1] holding lut[extracted value]
    (ref: wop_pbs/mod.rs vertical_packing:785-850).

    Non-power-of-2 LUT counts are zero-padded up to the tree width (the
    reference sizes the tree by ceil(log2) and treats missing leaves as
    zero polynomials, wop_pbs/mod.rs:468-560)."""
    dev = ggsw_bits[0].device
    if isinstance(luts, torch.Tensor):
        luts = luts.to(device=dev, dtype=torch.int64)
    else:
        luts = to_tensor(np.asarray(luts, np.uint64), dev)
    count = luts.shape[0]
    if count > 1 and count & (count - 1):
        pow2 = 1 << (count - 1).bit_length()
        luts = torch.cat([luts, luts.new_zeros((pow2 - count,
                                                luts.shape[-1]))])
        count = pow2
    log_count = max(count.bit_length() - 1, 0)
    n_tree = log_count if log_count <= len(ggsw_bits) else 0
    tree_bits = ggsw_bits[:n_tree]
    br_bits = ggsw_bits[n_tree:]
    if n_tree:
        glwe = cmux_tree(luts, tree_bits, glwe_size, cbs_base_log,
                         cbs_levels)
    else:
        glwe = _lut_glwes(luts[:1], glwe_size, ggsw_bits[0].shape[0])[0]
    glwe = vp_blind_rotate(glwe, br_bits, cbs_base_log, cbs_levels)
    return sample_extract(glwe)
