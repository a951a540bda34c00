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
n.  The subset keys are transformed once, into one of two layouts, as the
reference does (`prepare_multi_bit_bsk_auto`, tfhe_tpu/core/multibit.py:
198-213):
  * `PreparedMultiBitBskCuda` (`prepare_multi_bit_bsk_cuda`): the step runs
    on the kernels of `ops/fused_multibit.py`, in the schedule `mode` names
    ("scan3", the default, or "scan1");
  * `PreparedMultiBitBskNtt` (`prepare_multi_bit_bsk_ntt`, mode "ntt"): the
    reference's CRT-NTT layout, its layout whenever it is not on a TPU; the
    step is torch ops, as the reference's is jnp ops with no Pallas kernel
    (:216-294).
Execution is always deterministic: every sum has a fixed order, and the
arithmetic is exact, so both layouts give the same words.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..ops import ntt, polymul
from ..ops import fused_multibit
from ..ops.fused_multibit import (PreparedMultiBitBskCuda,
                                  multi_bit_blind_rotate_cuda,
                                  prepare_multi_bit_bsk_cuda)
from ..ops.polymul_ntt import (decompose_digits, digit_spectra,
                               inverse_residues, key_to_spectra,
                               residues_to_words)
from ..ops.torus import to_tensor, wrap
from ..prng.generators import EncryptionRandomGenerator
from .keygen import PreparedKsk, _np_udtype
from .keyswitch import keyswitch
from .pbs import NTT_MODE, modulus_switch, sample_extract

# every multi-bit blind-rotation mode: the two TPU schedules on the kernels'
# key layout, and the CRT-NTT layout's own
MULTI_BIT_MODES = fused_multibit.MODES + (NTT_MODE,)
# groups transformed at once by prepare_multi_bit_bsk_ntt: bounds its int64
# temporaries
_PREPARE_GROUPS = 8
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


def check_multi_bit_mode(mode: str) -> None:
    """Raises unless `mode` is one of `MULTI_BIT_MODES`."""
    if mode not in MULTI_BIT_MODES:
        raise ValueError(f"unknown multi-bit blind-rotation mode {mode!r}; "
                         f"expected one of {MULTI_BIT_MODES}")


@dataclass
class PreparedMultiBitBskNtt:
    """Multi-bit BSK in the CRT-NTT domain: spectra [n/gf, P, 2^gf, L, J=G,
    O=G, M=2, N] int32, balanced residues of the subset keys' 32-bit plane
    spectra (the reference's layout, tfhe_tpu/core/multibit.py:134-147,
    without its TPU DFT matrices; no Shoup companions: no kernel reads
    this layout)."""

    spectra: torch.Tensor
    base_log: int
    levels: int
    glwe_size: int
    polynomial_size: int
    input_dim: int
    grouping_factor: int
    bits: int = 64


def prepare_multi_bit_bsk_ntt(raw_bsk: torch.Tensor, base_log: int,
                              grouping_factor: int) -> PreparedMultiBitBskNtt:
    """Standard-domain multi-bit BSK [n/gf, 2^gf, L, G (row), G (poly), N]
    int64 on the 64-bit torus -> its NTT-domain key on the same device, in
    chunks of groups (counterpart of tfhe_tpu/core/multibit.py:163)."""
    n_groups, per, L, J, O, N = raw_bsk.shape
    if per != 1 << grouping_factor:
        raise ValueError(f"{per} GGSWs per group, expected "
                         f"2^{grouping_factor}")
    P, M = len(ntt.PRIMES), 2
    spectra = torch.empty((n_groups, P, per, L, J, O, M, N),
                          dtype=torch.int32, device=raw_bsk.device)
    for s in range(0, n_groups, _PREPARE_GROUPS):
        spec, _ = key_to_spectra(raw_bsk[s:s + _PREPARE_GROUPS], bits=64)
        spectra[s:s + _PREPARE_GROUPS] = spec.movedim(0, 1)
    return PreparedMultiBitBskNtt(
        spectra=spectra, base_log=base_log, levels=L, glwe_size=J,
        polynomial_size=N, input_dim=n_groups * grouping_factor,
        grouping_factor=grouping_factor)


def prepare_multi_bit_bsk(raw_bsk: torch.Tensor, base_log: int,
                          grouping_factor: int, mode: str):
    """The prepared key that `mode` runs on: the CRT-NTT layout for "ntt",
    the kernels' layout for "scan3" and "scan1" (the port's explicit
    counterpart of tfhe_tpu/core/multibit.py:198 prepare_multi_bit_bsk_auto)."""
    check_multi_bit_mode(mode)
    if mode == NTT_MODE:
        return prepare_multi_bit_bsk_ntt(raw_bsk, base_log, grouping_factor)
    return prepare_multi_bit_bsk_cuda(raw_bsk, base_log, grouping_factor)


def multi_bit_step_ntt(acc: torch.Tensor, d: torch.Tensor,
                       spec_group: torch.Tensor, base_log: int,
                       levels: int) -> torch.Tensor:
    """One group step in the CRT-NTT layout (the body of
    tfhe_tpu/core/multibit.py:256-291): acc [B, G, N] int64, d [B, 2^gf]
    switched subset sums in [0, 2N), spec_group [P, 2^gf, L, J, O, M, N]
    -> the new accumulator (GGSW_0 + sum_j GGSW_j X^{d_j}) (x) acc.

    Per prime the reference combines the key for each ciphertext, then
    multiplies by the digit spectra; here the monomials multiply the digit
    spectra and the key stays shared.  Every product is reduced mod p, so
    both orders give the same residues, and the CRT the same words."""
    B, G, N = acc.shape
    P, per, L, J, O, M, _ = spec_group.shape
    p = ntt.tables_for(N, acc.device).primes.view(P, 1, 1, 1, 1)
    dspec = digit_spectra(decompose_digits(acc, base_log, levels))
    mon = ntt.monomial_spectra(d, N).permute(2, 0, 1, 3)  # [P, B, per, N]
    # digit spectra times each subset's monomial: [P, B, per * L*J, 1, N]
    rot = (dspec.to(torch.int64)[:, :, None] * mon[:, :, :, None]) % p
    rot = rot.reshape(P, B, per * L * J, 1, N)
    key = spec_group.reshape(P, 1, per * L * J, O * M, N).to(torch.int64)
    prods = ((rot * key) % p).sum(dim=2) % p[..., 0]  # [P, B, O*M, N]
    res = inverse_residues(prods.permute(1, 2, 0, 3), O, M)
    return residues_to_words(res, 64)


def multi_bit_blind_rotate(mbsk: PreparedMultiBitBskCuda
                           | PreparedMultiBitBskNtt, lut: torch.Tensor,
                           lwe: torch.Tensor,
                           mode: Optional[str] = None) -> torch.Tensor:
    """lut [B, G, N] (or [G, N]) int64, lwe [B, n+1] int64 -> [B, G, N].

    acc := lut * X^{-b~}; then per group of gf mask elements the accumulator
    is replaced by (K_0 + sum_j K_j X^{d_j}) (x) acc (ref: lwe_multi_bit_
    programmable_bootstrapping.rs multi_bit_blind_rotate_assign).  The key's
    layout decides how each step runs; `mode` None runs the layout's default
    ("scan3" (K8) or "scan1" (K9) on the kernels' layout, "ntt" on the
    CRT-NTT layout), and a mode of the other layout raises."""
    ntt_layout = isinstance(mbsk, PreparedMultiBitBskNtt)
    if mode is not None:
        check_multi_bit_mode(mode)
        if ntt_layout != (mode == NTT_MODE):
            raise ValueError(f"mode {mode!r} does not run on a "
                             f"{type(mbsk).__name__} (the CRT-NTT layout "
                             f"runs {NTT_MODE!r}, the kernels' layout "
                             f"{fused_multibit.MODES})")
    N = mbsk.polynomial_size
    B = lwe.shape[0]
    if lut.dim() == 2:
        lut = lut.expand(B, *lut.shape)
    b_hat = modulus_switch(lwe[:, -1], N)
    acc = polymul.monomial_div(lut, b_hat[:, None], N)
    d_all = switched_subset_sums(lwe[:, :-1], mbsk.grouping_factor, N)
    if not ntt_layout:
        return multi_bit_blind_rotate_cuda(mbsk, acc, d_all,
                                           mode=mode or fused_multibit.MODES[0])
    for g in range(mbsk.input_dim // mbsk.grouping_factor):
        acc = multi_bit_step_ntt(acc, d_all[g], mbsk.spectra[g],
                                 mbsk.base_log, mbsk.levels)
    return acc


def multi_bit_programmable_bootstrap(mbsk: PreparedMultiBitBskCuda
                                     | PreparedMultiBitBskNtt,
                                     lut: torch.Tensor, lwe: torch.Tensor,
                                     mode: Optional[str] = None
                                     ) -> torch.Tensor:
    """[B, n+1] -> [B, k*N + 1] evaluating the LUT (ref:
    lwe_multi_bit_programmable_bootstrapping.rs
    multi_bit_programmable_bootstrap_lwe_ciphertext)."""
    return sample_extract(multi_bit_blind_rotate(mbsk, lut, lwe, mode))


def keyswitch_then_multi_bit_pbs(ksk: PreparedKsk,
                                 mbsk: PreparedMultiBitBskCuda
                                 | PreparedMultiBitBskNtt,
                                 lut: torch.Tensor, ct_big: torch.Tensor,
                                 mode: Optional[str] = None) -> torch.Tensor:
    """The shortint multi-bit pipeline (PBSOrder::KeyswitchBootstrap)."""
    return multi_bit_programmable_bootstrap(mbsk, lut, keyswitch(ksk, ct_big),
                                            mode)


def multi_bit_pbs_then_keyswitch(ksk: PreparedKsk,
                                 mbsk: PreparedMultiBitBskCuda
                                 | PreparedMultiBitBskNtt,
                                 lut: torch.Tensor, ct_small: torch.Tensor,
                                 mode: Optional[str] = None) -> torch.Tensor:
    """PBSOrder::BootstrapKeyswitch: the PBS on the small-key ciphertext,
    then the keyswitch of its big-key output back to the small key
    (tfhe_tpu/core/multibit.py:312)."""
    return keyswitch(ksk, multi_bit_programmable_bootstrap(mbsk, lut,
                                                           ct_small, mode))
