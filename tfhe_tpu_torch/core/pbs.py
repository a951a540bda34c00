"""Programmable bootstrap: modulus switch -> blind rotation -> sample extract.

Port of `tfhe_tpu/core/pbs.py` (ref: fft_impl/fft64/crypto/bootstrap.rs:
242-364 and fft_impl/common.rs:26-43).  The prepared key's layout decides
how the blind rotation runs, as in the reference (:69-88):
  * `PreparedBskCuda` (`ops/fused_pbs.py`): the step kernels of one of the
    reference's TPU schedules, the one `mode` names (`ops.fused_pbs.MODES`,
    default "scan2"; every schedule gives the same words);
  * `PreparedBskNtt` (`ops/polymul_ntt.py`): a Python loop over the n steps
    of monomial rotation, rotated - acc, `external_product_ntt` (K10's
    counterpart, one launch a step for every prime) and add, at 32, 64 or 128 bits; its only
    mode is "ntt", and naming a `fused_pbs` schedule with it raises.
Kernels run on CUDA tensors, their plain versions on CPU tensors.  A zero
mask element contributes an exactly-zero update (acc * X^0 - acc = 0), so
the reference's skip-if-zero branch needs no data-dependent control flow.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops import polymul, u128
from ..ops.fused_pbs import (MODES, PreparedBskCuda, blind_rotate_fused,
                             prepare_bsk_cuda)
from ..ops.polymul_ntt import (PreparedBskNtt, external_product_ntt,
                               prepare_bsk_ntt)
from ..ops.torus import lsr, wrap
from ..utils.profiling import annotate, counter
from .keygen import PreparedKsk
from .keyswitch import keyswitch

NTT_MODE = "ntt"
# every classic blind-rotation mode: the six TPU schedules on the kernels'
# key layout, and the CRT-NTT layout's own
CLASSIC_MODES = MODES + (NTT_MODE,)

# every keyswitch + PBS batch the program runs, classic or multi-bit, and
# its ciphertexts: counted where the four pipelines below (and their
# multi-bit counterparts) start, the one boundary every caller crosses
PBS_BATCHES = counter("pbs.batches")
PBS_ROWS = counter("pbs.rows")


def count_pbs(rows: int) -> None:
    """Counts one keyswitch + PBS batch of `rows` ciphertexts."""
    PBS_BATCHES.value += 1
    PBS_ROWS.value += rows


def check_classic_mode(mode: str) -> None:
    """Raises unless `mode` is one of `CLASSIC_MODES`."""
    if mode not in CLASSIC_MODES:
        raise ValueError(f"unknown blind-rotation mode {mode!r}; expected one "
                         f"of {CLASSIC_MODES}")


def prepare_classic_bsk(raw_bsk: torch.Tensor, base_log: int, bits: int,
                        mode: str):
    """The prepared key that `mode` runs on: the CRT-NTT layout for "ntt",
    the kernels' layout for the six TPU schedules (the port's explicit
    counterpart of tfhe_tpu/core/__init__.py:29 prepare_bsk_auto)."""
    check_classic_mode(mode)
    if mode == NTT_MODE:
        return prepare_bsk_ntt(raw_bsk, base_log, bits=bits,
                               device=raw_bsk.device)
    return prepare_bsk_cuda(raw_bsk, base_log, bits=bits)


def modulus_switch(x: torch.Tensor, N: int, bits: int = 64) -> torch.Tensor:
    """Round torus words onto Z_{2N} -> int32; may return 2N (== 0 as a
    rotation) (ref: fft_impl/common.rs:26-43 fast_pbs_modulus_switch)."""
    log2n = N.bit_length() - 1
    out = lsr(x, bits - log2n - 2, bits) + 1
    return (out >> 1).to(torch.int32)


def blind_rotate(bsk: PreparedBskCuda | PreparedBskNtt, lut: torch.Tensor,
                 lwe: torch.Tensor, mode: Optional[str] = None
                 ) -> torch.Tensor:
    """lut [B, G, N] (or [G, N]) int64, lwe [B, n+1] int64 -> [B, G, N]
    (at 128 bits, every word a [..., 2] pair).

    acc := lut * X^{-b~}; then for each mask element a_i:
      acc += GGSW_i (x) (acc * X^{a~_i} - acc)
    (ref: bootstrap.rs:242-331 blind_rotate_assign).  `mode` None runs the
    key layout's default schedule."""
    ntt_layout = isinstance(bsk, PreparedBskNtt)
    if ntt_layout and mode not in (None, NTT_MODE):
        check_classic_mode(mode)
        raise ValueError(f"mode {mode!r} needs the kernels' key layout "
                         f"(prepare_bsk_cuda); a PreparedBskNtt runs "
                         f"{NTT_MODE!r}")
    if not ntt_layout and mode == NTT_MODE:
        raise ValueError("mode 'ntt' needs the CRT-NTT key layout "
                         "(prepare_bsk_ntt)")
    if bsk.bits == 128:
        return _blind_rotate_u128(bsk, lut, lwe)
    bits = bsk.bits
    N = bsk.polynomial_size
    B = lwe.shape[0]
    if lut.dim() == 2:
        lut = lut.expand(B, *lut.shape)
    b_hat = modulus_switch(lwe[:, -1], N, bits=bits)
    acc = polymul.monomial_div(lut, b_hat[:, None], N, bits=bits)
    ahat = modulus_switch(lwe[:, :-1], N, bits=bits).t().contiguous()  # [n, B]
    if not ntt_layout:
        return blind_rotate_fused(bsk, acc, ahat, mode or MODES[0])
    # the CRT-NTT layout's step loop (tfhe_tpu/core/pbs.py:74-88)
    for i in range(bsk.input_dim):
        rotated = polymul.monomial_mul(acc, ahat[i][:, None], N, bits=bits)
        delta = external_product_ntt(
            wrap(rotated - acc, bits), bsk.spectra[i], bsk.shoup[i],
            bsk.base_log, bsk.levels, bits)
        acc = wrap(acc + delta, bits)
    return acc


def _blind_rotate_u128(bsk: PreparedBskNtt, lut: torch.Tensor,
                       lwe: torch.Tensor) -> torch.Tensor:
    """128-bit-torus blind rotation (tfhe_tpu/core/pbs.py:104-139; the
    fft128 analog, ref: lwe_programmable_bootstrapping.rs:1327 f128 PBS).

    lut [B, G, N, 2] (or [G, N, 2]), lwe [B, n+1, 2] int64 pairs.  The
    modulus switch and the decomposition read only the high word;
    rotations and adds carry across the pair; the external product runs
    the CRT-NTT with four 32-bit key planes."""
    N = bsk.polynomial_size
    B = lwe.shape[0]
    if lut.dim() == 3:
        lut = lut.expand(B, *lut.shape)
    b_hat = modulus_switch(lwe[:, -1, 1], N, bits=64)  # high word only
    acc = u128.monomial_div(lut, b_hat[:, None], N)
    ahat = modulus_switch(lwe[:, :-1, 1], N, bits=64).t()  # [n, B]
    for i in range(bsk.input_dim):
        rotated = u128.monomial_mul(acc, ahat[i][:, None], N)
        delta = external_product_ntt(
            u128.sub(rotated, acc), bsk.spectra[i], bsk.shoup[i],
            bsk.base_log, bsk.levels, bits=128)
        acc = u128.add(acc, delta)
    return acc


def sample_extract(glwe: torch.Tensor, bits: int = 64) -> torch.Tensor:
    """Constant coefficient as an LWE ciphertext: [..., G, N] -> [..., k*N+1]
    (ref: algorithms/glwe_sample_extraction.rs:91-147, nth = 0:
    out_mask[j*N] = mask[j, 0]; out_mask[j*N + i] = -mask[j, N-i], i > 0)."""
    mask = glwe[..., :-1, :]
    body = glwe[..., -1, 0]
    rest = wrap(-torch.flip(mask[..., :, 1:], dims=[-1]), bits)
    out_mask = torch.cat([mask[..., :, 0:1], rest], dim=-1)
    k, N = glwe.shape[-2] - 1, glwe.shape[-1]
    out_mask = out_mask.reshape(*glwe.shape[:-2], k * N)
    return torch.cat([out_mask, body[..., None]], dim=-1)


def sample_extract_u128(glwe: torch.Tensor) -> torch.Tensor:
    """u128 sample extract: glwe [..., G, N, 2] -> lwe [..., k*N + 1, 2]
    (tfhe_tpu/core/pbs.py:142-152)."""
    mask = glwe[..., :-1, :, :]
    body = glwe[..., -1, 0, :]
    rest = u128.neg(torch.flip(mask[..., :, 1:, :], dims=[-2]))
    out_mask = torch.cat([mask[..., :, 0:1, :], rest], dim=-2)
    out_mask = out_mask.reshape(*glwe.shape[:-3], -1, 2)
    return torch.cat([out_mask, body[..., None, :]], dim=-2)


def programmable_bootstrap(bsk: PreparedBskCuda | PreparedBskNtt,
                           lut: torch.Tensor, lwe: torch.Tensor,
                           mode: Optional[str] = None) -> torch.Tensor:
    """Classic PBS: [B, n+1] -> [B, k*N + 1] evaluating the LUT
    (ref: algorithms/lwe_programmable_bootstrapping.rs:1017; the 128-bit
    key's path is the f128 variant at :1327, on [..., 2] pairs)."""
    glwe = blind_rotate(bsk, lut, lwe, mode)
    if bsk.bits == 128:
        return sample_extract_u128(glwe)
    return sample_extract(glwe, bits=bsk.bits)


def keyswitch_then_pbs(ksk: PreparedKsk,
                       bsk: PreparedBskCuda | PreparedBskNtt,
                       lut: torch.Tensor, ct_big: torch.Tensor,
                       mode: Optional[str] = None) -> torch.Tensor:
    """The shortint default pipeline (PBSOrder::KeyswitchBootstrap,
    ref: shortint/server_key/mod.rs:783-857).  One batch of
    `PBS_BATCHES`, in a `core.pbs` span."""
    rows = ct_big.shape[0]
    with annotate("core.pbs", rows=rows, mode=mode):
        count_pbs(rows)
        return programmable_bootstrap(bsk, lut, keyswitch(ksk, ct_big), mode)


def pbs_then_keyswitch(ksk: PreparedKsk,
                       bsk: PreparedBskCuda | PreparedBskNtt,
                       lut: torch.Tensor, ct_small: torch.Tensor,
                       mode: Optional[str] = None) -> torch.Tensor:
    """PBSOrder::BootstrapKeyswitch, the boolean DEFAULT_PARAMETERS path
    (tfhe_tpu/core/pbs.py:189).  One batch of `PBS_BATCHES`, in a
    `core.pbs` span."""
    rows = ct_small.shape[0]
    with annotate("core.pbs", rows=rows, mode=mode):
        count_pbs(rows)
        return keyswitch(ksk, programmable_bootstrap(bsk, lut, ct_small,
                                                     mode))
