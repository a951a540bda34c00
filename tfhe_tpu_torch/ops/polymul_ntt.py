"""GGSW external product in the CRT-NTT domain, on the Shoup MAC kernel.

Port of `tfhe_tpu/ops/polymul_ntt.py` (ref: tfhe/src/core_crypto/fft_impl/
fft64/crypto/ggsw.rs:477-598, with an exact integer transform in place of
f64 FFTs).  The bootstrap key is transformed once into balanced per-prime
spectra of its 32-bit planes with 16-bit Shoup companions
(`prepare_bsk_ntt`), and every blind-rotation step is

    decompose -> forward NTT -> Shoup MAC over the L*G digits, per prime
    -> inverse NTT -> CRT -> recombine the planes into torus words

The MAC runs K10's counterpart (`ops/shoup_mac.py`), once per prime and
step; the decomposition, the transforms and the CRT stay torch ops on
every device, as they are jnp ops (not Pallas) in the reference.  The
transforms are this port's (`ops/ntt.py`, bit-reversed spectra): the MAC
is pointwise in N, so the spectrum order does not reach any result.

The torus width picks the key planes: one of 32 bits for the u32 torus,
two for the u64 torus and four for the u128 torus (`ops/u128.py` pairs).
Each plane's convolution stays below 2^67, inside the five primes' centred
CRT range, so the result is the exact convolution mod 2^bits.  At 128 bits
the digits come from the high word alone, which holds every bit they need
while base_log * levels <= 62 (tfhe_tpu/ops/polymul_ntt.py:89).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from . import ntt, u128
from .decomposition import signed_decompose
from .fused_pbs import residues_to_torus
from .shoup_mac import shoup_mac
from .torus import MASK32, lsr, to_tensor

# blind-rotation steps transformed at once by prepare_bsk_ntt: bounds its
# int64 temporaries
_PREPARE_CHUNK = 64


@dataclass
class PreparedBskNtt:
    """BSK in the CRT-NTT domain: spectra / shoup [n, P, L, J, O, M, N]
    int32, balanced residues of the key planes' spectra and their 16-bit
    Shoup companions (the reference's layout, without its TPU DFT
    matrices)."""

    spectra: torch.Tensor
    shoup: torch.Tensor
    base_log: int
    levels: int
    glwe_size: int
    polynomial_size: int
    input_dim: int
    bits: int = 64


def _primes(x: torch.Tensor) -> torch.Tensor:
    """The primes [P, 1] as a cached int64 tensor on x's device, to reduce
    x [..., P, N]."""
    return ntt.tables_for(x.shape[-1], x.device).primes.view(-1, 1)


def key_planes(key: torch.Tensor, bits: int) -> torch.Tensor:
    """Torus key polynomials [..., N] (at 128 bits [..., N, 2] pairs) ->
    [..., M, N] int64 planes of 32 unsigned bits, M = bits / 32."""
    if bits == 128:
        return u128.to_planes32(key)
    if bits == 64:
        return torch.stack([key & MASK32, lsr(key, 32)], dim=-2)
    return key.unsqueeze(-2)


def key_to_spectra(key: torch.Tensor, bits: int = 64):
    """Torus key polynomials -> (spectra, shoup) [P, ..., M, N] int32:
    balanced residues of each plane's forward NTT, and round(s * 2^16 / p)
    (counterpart of tfhe_tpu/ops/polymul_ntt.py:41)."""
    spec = ntt.forward_ntt(key_planes(key, bits))  # [..., M, P, N]
    p = _primes(spec)
    bal = ntt.to_balanced(spec, p)
    sh = ntt.shoup16(bal, p)
    return bal.movedim(-2, 0), sh.movedim(-2, 0)


def prepare_bsk_ntt(raw_bsk, base_log: int, bits: int = 64,
                    device="cuda") -> PreparedBskNtt:
    """Standard-domain BSK [n, L, G (row j), G (poly o), N] (at 128 bits
    [..., N, 2] pairs), as torus-word tensors or the reference's numpy
    uint arrays -> the NTT-domain key on `device` (counterpart of
    tfhe_tpu/ops/polymul_ntt.py:161)."""
    dev = resolve_device(device)
    if isinstance(raw_bsk, torch.Tensor):
        raw = raw_bsk.to(device=dev, dtype=torch.int64)
    elif bits == 128:
        raw = u128.to_tensor(raw_bsk, dev)
    else:
        raw = to_tensor(np.asarray(raw_bsk), dev)
    if (bits not in (32, 64, 128) or raw.dim() != (6 if bits == 128 else 5)
            or raw.shape[2] != raw.shape[3]):
        raise ValueError(f"BSK of shape {tuple(raw.shape)} at {bits} bits")
    n, L, J, O, N = raw.shape[:5]
    P, M = len(ntt.PRIMES), bits // 32
    spectra = torch.empty((n, P, L, J, O, M, N), dtype=torch.int32,
                          device=dev)
    shoup = torch.empty_like(spectra)
    for s in range(0, n, _PREPARE_CHUNK):
        spec, sh = key_to_spectra(raw[s:s + _PREPARE_CHUNK], bits)
        spectra[s:s + _PREPARE_CHUNK] = spec.movedim(0, 1)
        shoup[s:s + _PREPARE_CHUNK] = sh.movedim(0, 1)
    return PreparedBskNtt(spectra=spectra, shoup=shoup, base_log=base_log,
                          levels=L, glwe_size=J, polynomial_size=N,
                          input_dim=n, bits=bits)


# -- the stages of one external product -------------------------------------


def decompose_digits(acc_diff: torch.Tensor, base_log: int, levels: int,
                     bits: int = 64) -> torch.Tensor:
    """acc_diff [B, G, N] torus words ([B, G, N, 2] at 128 bits) -> signed
    digits [B, L*G, N] int64, level-major (row l*G + g)."""
    if bits == 128:
        if base_log * levels > 62:
            raise ValueError("u128 decomposition needs base_log * levels "
                             "<= 62")
        acc_diff, bits = acc_diff[..., 1], 64
    B, G, N = acc_diff.shape
    digits = signed_decompose(acc_diff, base_log, levels, bits=bits)
    return digits.permute(0, 3, 1, 2).reshape(B, levels * G, N).to(
        torch.int64)


def digit_spectra(digits: torch.Tensor) -> torch.Tensor:
    """digits [B, LJ, N] -> [P, B, LJ, N] balanced int32 spectra, one
    contiguous block per prime."""
    spec = ntt.forward_ntt(digits)  # [B, LJ, P, N]
    bal = ntt.to_balanced(spec, _primes(spec))
    return bal.permute(2, 0, 1, 3).contiguous()


def spectral_mac(dspec: torch.Tensor, spec_step: torch.Tensor,
                 shoup_step: torch.Tensor) -> torch.Tensor:
    """dspec [P, B, LJ, N]; one step's spec / shoup [P, L, J, O, M, N] ->
    [B, O*M, P, N] balanced int32: K10 once per prime."""
    P, B, LJ, N = dspec.shape
    OM = spec_step.shape[3] * spec_step.shape[4]
    prods = [shoup_mac(dspec[i], spec_step[i].reshape(LJ, OM, N),
                       shoup_step[i].reshape(LJ, OM, N), int(p))
             for i, p in enumerate(ntt.PRIMES)]
    return torch.stack(prods, dim=2)


def inverse_residues(prods: torch.Tensor, O: int, M: int) -> torch.Tensor:
    """[B, O*M, P, N] balanced spectra -> [B, O, M, P, N] canonical
    residues of the convolutions."""
    B, _, P, N = prods.shape
    canon = torch.remainder(prods.to(torch.int64), _primes(prods))
    return ntt.inverse_ntt(canon).reshape(B, O, M, P, N)


def residues_to_words(res: torch.Tensor, bits: int = 64) -> torch.Tensor:
    """[B, O, M, P, N] residues -> [B, O, N] torus words ([B, O, N, 2] at
    128 bits): the CRT, then the planes joined (u32: plane 0; u64:
    conv0 + conv1 * 2^32; u128: sum_m conv_m * 2^(32 m))."""
    if bits == 128:
        return u128.planes_to_u128(ntt.crt_to_u128_centered(res))
    return residues_to_torus(res, bits)


def external_product_ntt(acc_diff: torch.Tensor, spec_step: torch.Tensor,
                         shoup_step: torch.Tensor, base_log: int,
                         levels: int, bits: int = 64) -> torch.Tensor:
    """One blind-rotation step's GGSW external product, exactly
    (counterpart of tfhe_tpu/ops/polymul_ntt.py:73).

    acc_diff [B, G, N] torus words (rotated - acc; [B, G, N, 2] at 128
    bits); spec_step / shoup_step [P, L, J=G, O=G, M, N] -> the delta
    [B, O, N] (or [B, O, N, 2]) to add to the accumulator."""
    O, M = spec_step.shape[3], spec_step.shape[4]
    digits = decompose_digits(acc_diff, base_log, levels, bits)
    prods = spectral_mac(digit_spectra(digits), spec_step, shoup_step)
    return residues_to_words(inverse_residues(prods, O, M), bits)
