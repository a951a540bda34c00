"""Multi-bit programmable bootstrap: key generation and the blind rotation.

Port of `tfhe_tpu/core/multibit.py` (ref: tfhe/src/core_crypto/algorithms/
lwe_multi_bit_bootstrap_key_generation.rs:87-178 keygen, :401-427
combine_key_bits; lwe_multi_bit_programmable_bootstrapping.rs:295-460 blind
rotation).

The BSK groups gf secret bits; each group stores 2^gf GGSWs, the j-th
encrypting 1 exactly when the group's key bits equal the bits of j
(MSB-first).  Per group step the per-ciphertext combined GGSW
    K_0 + sum_{j>=1} K_j * X^{d_j},  d_j = switch(sum_{i in j} a_i)
encrypts X^{switch(<a_group, s_group>)}, and the accumulator is replaced by
its external product with the accumulator: n/gf sequential steps instead of
n.  The subset keys are transformed once (`prepare_multi_bit_bsk_cuda`); the
step runs on the kernels of `ops/fused_multibit.py`, in the schedule chosen
by `mode`.  Execution is always deterministic: every sum has a fixed order.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import polymul
from ..ops.fused_multibit import (PreparedMultiBitBskCuda,
                                  multi_bit_blind_rotate_cuda,
                                  prepare_multi_bit_bsk_cuda)
from ..ops.torus import to_tensor, wrap
from ..prng.generators import EncryptionRandomGenerator
from .keygen import PreparedKsk, _np_udtype
from .keyswitch import keyswitch
from .pbs import modulus_switch, sample_extract
from .secret import GlweSecretKey, LweSecretKey, glwe_phase


def combine_key_bits(bit_selector: int, key_bits) -> int:
    """Indicator that the group's key bits equal `bit_selector` (MSB-first)
    (ref: lwe_multi_bit_bootstrap_key_generation.rs:401-427)."""
    acc = 1
    gf = len(key_bits)
    for bit_idx, key_bit in enumerate(key_bits):
        bit_position = gf - (bit_idx + 1)
        inversion_bit = ((bit_selector >> bit_position) & 1) ^ 1
        acc *= int(key_bit) ^ inversion_bit
    return acc


def generate_multi_bit_bootstrap_key(
        lwe_sk: LweSecretKey, glwe_sk: GlweSecretKey, base_log: int,
        levels: int, noise_std: float, grouping_factor: int,
        gen: EncryptionRandomGenerator) -> torch.Tensor:
    """Standard-domain multi-bit BSK on the GLWE key's device:
    [n/gf groups, 2^gf, levels, G (row), G (poly), N] int64.

    GGSW j of group g encrypts combine_key_bits(j, s_group), drawn through
    the reference's fork tree (group -> GGSW -> level -> row), so the same
    seed gives the same bytes.  Mask and noise bytes are drawn on the host in
    that order; the rows' GLWE phases run in one batched product on the
    device, as in `generate_bootstrap_key`."""
    bits = glwe_sk.bits
    dt = _np_udtype(bits)
    dev = glwe_sk.bits_array.device
    n = lwe_sk.lwe_dimension
    gf = grouping_factor
    if n % gf:
        raise ValueError(f"lwe_dimension {n} not divisible by grouping {gf}")
    n_groups = n // gf
    per = 1 << gf
    k, N = glwe_sk.bits_array.shape
    G = k + 1

    masks = np.empty((n_groups, per, levels, G, k, N), dtype=dt)
    noises = np.empty((n_groups, per, levels, G, N), dtype=dt)
    # GGSW (g, j) level l presets factor * s_r (rows r < k) and -factor at
    # X^0 (last row), factor = -m * 2^(bits - bl*(l+1))
    factors = np.empty((n_groups, per, levels), dtype=dt)
    key_bits = lwe_sk.bits_array.cpu().numpy()

    group_children = gen.fork_multi_bit_bsk_to_ggsw_group(
        n, levels, G, N, gf, bits=bits)
    with np.errstate(over="ignore"):
        for g, child in enumerate(group_children):
            group_bits = key_bits[g * gf:(g + 1) * gf]
            ggsw_children = child.fork_multi_bit_bsk_ggsw_group_to_ggsw(
                levels, G, N, gf, bits=bits)
            for j, genj in enumerate(ggsw_children):
                m = dt(combine_key_bits(j, group_bits))
                lev_children = genj.fork_ggsw_to_ggsw_levels(
                    levels, G, N, bits=bits)
                for lev, genl in enumerate(lev_children):
                    factors[g, j, lev] = (dt(0) - m) << dt(
                        bits - base_log * (lev + 1))
                    row_children = genl.fork_ggsw_level_to_glwe(
                        G, N, bits=bits)
                    for r, genr in enumerate(row_children):
                        masks[g, j, lev, r] = genr.random_mask(
                            k * N, bits=bits).reshape(k, N)
                        noises[g, j, lev, r] = genr.random_noise(
                            N, noise_std, bits=bits)

    masks_t = to_tensor(masks, dev)
    factor_t = to_tensor(factors, dev)[..., None, None]  # [ng, per, L, 1, 1]
    s_polys = glwe_sk.bits_array  # [k, N]
    presets = torch.zeros((n_groups, per, levels, G, N), dtype=torch.int64,
                          device=dev)
    presets[..., :k, :] = wrap(factor_t * s_polys, bits)
    presets[..., k, 0] = wrap(-factor_t[..., 0, 0], bits)
    phase = glwe_phase(s_polys, masks_t.reshape(-1, k, N), bits=bits
                       ).reshape(n_groups, per, levels, G, N)
    bodies = wrap(presets + phase + to_tensor(noises, dev), bits)
    return torch.cat([masks_t, bodies[..., None, :]], dim=4)


def switched_subset_sums(mask: torch.Tensor, grouping_factor: int,
                         N: int) -> torch.Tensor:
    """mask [B, n] int64 (64-bit torus) -> [n/gf, B, 2^gf] int32: for group g
    and subset j (bit gf-1-i of j selects a_{g*gf+i}), switch(sum of the
    selected a_i) mod 2N.  The sum wraps on the torus before the switch, as the reference's
    switch(<a_S, 1>) does (core/multibit.py:260-261)."""
    B, n = mask.shape
    gf = grouping_factor
    groups = mask.reshape(B, n // gf, gf)
    sums = []
    for j in range(1 << gf):
        s = torch.zeros_like(groups[..., 0])
        for i in range(gf):
            if (j >> (gf - 1 - i)) & 1:
                s = wrap(s + groups[..., i], 64)
        sums.append(s)
    d = modulus_switch(torch.stack(sums, dim=-1), N)
    return (d & (2 * N - 1)).permute(1, 0, 2).contiguous()


def multi_bit_blind_rotate(mbsk: PreparedMultiBitBskCuda, lut: torch.Tensor,
                           lwe: torch.Tensor,
                           mode: str = "scan3") -> torch.Tensor:
    """lut [B, G, N] (or [G, N]) int64, lwe [B, n+1] int64 -> [B, G, N].

    acc := lut * X^{-b~}; then per group of gf mask elements the accumulator
    is replaced by (K_0 + sum_j K_j X^{d_j}) (x) acc (ref: lwe_multi_bit_
    programmable_bootstrapping.rs multi_bit_blind_rotate_assign).  `mode`
    picks the schedule of each step: "scan3" (K8) or "scan1" (K9)."""
    N = mbsk.polynomial_size
    B = lwe.shape[0]
    if lut.dim() == 2:
        lut = lut.expand(B, *lut.shape)
    b_hat = modulus_switch(lwe[:, -1], N)
    acc = polymul.monomial_div(lut, b_hat[:, None], N)
    d_all = switched_subset_sums(lwe[:, :-1], mbsk.grouping_factor, N)
    return multi_bit_blind_rotate_cuda(mbsk, acc, d_all, mode=mode)


def multi_bit_programmable_bootstrap(mbsk: PreparedMultiBitBskCuda,
                                     lut: torch.Tensor, lwe: torch.Tensor,
                                     mode: str = "scan3") -> torch.Tensor:
    """[B, n+1] -> [B, k*N + 1] evaluating the LUT (ref:
    lwe_multi_bit_programmable_bootstrapping.rs
    multi_bit_programmable_bootstrap_lwe_ciphertext)."""
    return sample_extract(multi_bit_blind_rotate(mbsk, lut, lwe, mode))


def keyswitch_then_multi_bit_pbs(ksk: PreparedKsk,
                                 mbsk: PreparedMultiBitBskCuda,
                                 lut: torch.Tensor, ct_big: torch.Tensor,
                                 mode: str = "scan3") -> torch.Tensor:
    """The shortint multi-bit pipeline (PBSOrder::KeyswitchBootstrap)."""
    return multi_bit_programmable_bootstrap(mbsk, lut, keyswitch(ksk, ct_big),
                                            mode)


def multi_bit_pbs_then_keyswitch(ksk: PreparedKsk,
                                 mbsk: PreparedMultiBitBskCuda,
                                 lut: torch.Tensor, ct_small: torch.Tensor,
                                 mode: str = "scan3") -> torch.Tensor:
    """PBSOrder::BootstrapKeyswitch: the PBS on the small-key ciphertext,
    then the keyswitch of its big-key output back to the small key
    (tfhe_tpu/core/multibit.py:312)."""
    return keyswitch(ksk, multi_bit_programmable_bootstrap(mbsk, lut,
                                                           ct_small, mode))
