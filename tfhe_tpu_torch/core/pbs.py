"""Programmable bootstrap: modulus switch -> blind rotation -> sample extract.

Port of `tfhe_tpu/core/pbs.py` (ref: fft_impl/fft64/crypto/bootstrap.rs:
242-364 and fft_impl/common.rs:26-43).  The blind rotation runs the step
kernels of `ops/fused_pbs.py` on CUDA tensors and their plain versions on
CPU tensors, in the schedule that `mode` names (`ops.fused_pbs.MODES`;
every schedule gives the same words).  A zero mask element contributes an
exactly-zero update (acc * X^0 - acc = 0), so the reference's skip-if-zero
branch needs no data-dependent control flow.
"""

from __future__ import annotations

import torch

from ..ops import polymul
from ..ops.fused_pbs import PreparedBskCuda, blind_rotate_fused
from ..ops.torus import lsr, wrap
from .keygen import PreparedKsk
from .keyswitch import keyswitch


def modulus_switch(x: torch.Tensor, N: int, bits: int = 64) -> torch.Tensor:
    """Round torus words onto Z_{2N} -> int32; may return 2N (== 0 as a
    rotation) (ref: fft_impl/common.rs:26-43 fast_pbs_modulus_switch)."""
    log2n = N.bit_length() - 1
    out = lsr(x, bits - log2n - 2, bits) + 1
    return (out >> 1).to(torch.int32)


def blind_rotate(bsk: PreparedBskCuda, lut: torch.Tensor,
                 lwe: torch.Tensor, mode: str = "scan2") -> torch.Tensor:
    """lut [B, G, N] (or [G, N]) int64, lwe [B, n+1] int64 -> [B, G, N].

    acc := lut * X^{-b~}; then for each mask element a_i:
      acc += GGSW_i (x) (acc * X^{a~_i} - acc)
    (ref: bootstrap.rs:242-331 blind_rotate_assign)."""
    bits = bsk.bits
    N = bsk.polynomial_size
    B = lwe.shape[0]
    if lut.dim() == 2:
        lut = lut.expand(B, *lut.shape)
    b_hat = modulus_switch(lwe[:, -1], N, bits=bits)
    acc = polymul.monomial_div(lut, b_hat[:, None], N, bits=bits)
    ahat = modulus_switch(lwe[:, :-1], N, bits=bits).t().contiguous()  # [n, B]
    return blind_rotate_fused(bsk, acc, ahat, mode)


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


def programmable_bootstrap(bsk: PreparedBskCuda, lut: torch.Tensor,
                           lwe: torch.Tensor,
                           mode: str = "scan2") -> torch.Tensor:
    """Classic PBS: [B, n+1] -> [B, k*N + 1] evaluating the LUT
    (ref: algorithms/lwe_programmable_bootstrapping.rs:1017)."""
    return sample_extract(blind_rotate(bsk, lut, lwe, mode), bits=bsk.bits)


def keyswitch_then_pbs(ksk: PreparedKsk, bsk: PreparedBskCuda,
                       lut: torch.Tensor, ct_big: torch.Tensor,
                       mode: str = "scan2") -> torch.Tensor:
    """The shortint default pipeline (PBSOrder::KeyswitchBootstrap,
    ref: shortint/server_key/mod.rs:783-857)."""
    return programmable_bootstrap(bsk, lut, keyswitch(ksk, ct_big), mode)


def pbs_then_keyswitch(ksk: PreparedKsk, bsk: PreparedBskCuda,
                       lut: torch.Tensor, ct_small: torch.Tensor,
                       mode: str = "scan2") -> torch.Tensor:
    """PBSOrder::BootstrapKeyswitch, the boolean DEFAULT_PARAMETERS path
    (tfhe_tpu/core/pbs.py:189)."""
    return keyswitch(ksk, programmable_bootstrap(bsk, lut, ct_small, mode))
