"""Shortint server key and its lookup-table operations.

Port of `tfhe_tpu/shortint/server_key.py` (ref: tfhe/src/shortint/server_key/
mod.rs).  Every operation reduces to `_pbs_device`: one keyswitch + PBS over
a whole batch of blocks (ref: mod.rs:783-857), which on a card runs the
blind-rotation kernels of `ops/fused_pbs.py` (classic parameters) or of
`ops/fused_multibit.py` (multi-bit parameters, in the default schedule).
The reference's XLA shape buckets and on-disk key cache have no counterpart
here: PyTorch runs eagerly at any batch size, and nothing is written to
disk.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from .. import core
from ..device import resolve_device
from ..ops.torus import to_tensor
from ..params import ClassicPBSParameters, MultiBitPBSParameters, PBSOrder
from .ciphertext import ShortintBatch
from .client_key import ClientKey


@dataclass(frozen=True)
class LookupTable:
    """(ref: shortint/server_key/mod.rs LookupTableOwned)"""

    acc: torch.Tensor  # [G, N] int64
    degree: int


@dataclass(frozen=True)
class BivariateLookupTable:
    acc: LookupTable
    factor: int  # lhs is scaled by this before packing


def _as_key_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64)
    return to_tensor(np.asarray(x), device)


class ServerKey:
    def __init__(self, cks: ClientKey, _raw=None, device=None):
        p = cks.params
        if p.pbs_order is not PBSOrder.KEYSWITCH_BOOTSTRAP:
            raise NotImplementedError(
                "only the keyswitch-then-bootstrap order is ported")
        self.params = p
        self.device = resolve_device(device if device is not None
                                     else cks.device)
        self.message_modulus = p.message_modulus
        self.carry_modulus = p.carry_modulus
        self.max_degree = p.total_modulus - 1
        self.is_multi_bit = isinstance(p, MultiBitPBSParameters)
        if self.is_multi_bit and p.torus_bits != 64:
            raise ValueError("multi-bit keys are on the 64-bit torus only")
        if _raw is None:
            if self.is_multi_bit:
                bsk = core.generate_multi_bit_bootstrap_key(
                    cks.lwe_sk, cks.glwe_sk, p.pbs_base_log, p.pbs_level,
                    p.glwe_modular_std_dev, p.grouping_factor, cks.enc_gen)
            else:
                bsk = core.generate_bootstrap_key(
                    cks.lwe_sk, cks.glwe_sk, p.pbs_base_log, p.pbs_level,
                    p.glwe_modular_std_dev, cks.enc_gen)
            ksk = core.generate_keyswitch_key(
                cks.big_sk, cks.lwe_sk, p.ks_base_log, p.ks_level,
                p.lwe_modular_std_dev, cks.enc_gen)
        else:
            bsk, ksk = (_as_key_tensor(k, self.device) for k in _raw)
        self.raw_bsk = bsk
        self.raw_ksk = ksk
        if self.is_multi_bit:
            self.bsk = core.prepare_multi_bit_bsk_cuda(bsk, p.pbs_base_log,
                                                       p.grouping_factor)
        else:
            self.bsk = core.prepare_bsk_cuda(bsk, p.pbs_base_log)
        self.ksk = core.prepare_ksk(ksk, p.ks_base_log)
        self._lut_cache: dict = {}
        self.ciphertext_lwe_size = p.ciphertext_lwe_size

    @classmethod
    def from_raw(cls, params: ClassicPBSParameters | MultiBitPBSParameters,
                 bsk, ksk, device="cuda") -> "ServerKey":
        """Rebuild a server key from raw standard-domain BSK / KSK arrays
        (numpy uint64 or int64 tensors); a multi-bit BSK is
        [n/gf, 2^gf, L, G, G, N]."""
        shell = ClientKey.__new__(ClientKey)
        shell.params = params
        return cls(shell, _raw=(bsk, ksk), device=device)

    # -- lookup tables --

    def generate_lookup_table(self, f: Callable[[int], int]) -> LookupTable:
        """(ref: mod.rs:383-399 generate_lookup_table; engine/mod.rs:72-128)"""
        p = self.params
        table = tuple(int(f(i)) % (1 << 64) for i in range(p.total_modulus))
        if table in self._lut_cache:
            return self._lut_cache[table]
        acc, degree = core.make_lut_glwe(
            list(table), p.polynomial_size, p.glwe_size, p.total_modulus,
            p.delta, device=self.device)
        lut = LookupTable(acc=acc, degree=min(degree, self.max_degree))
        self._lut_cache[table] = lut
        return lut

    def generate_lookup_table_bivariate_with_factor(
            self, f: Callable[[int, int], int],
            factor: int) -> BivariateLookupTable:
        """(ref: bivariate_pbs.rs:71-129) packed input = lhs*factor + rhs."""
        msg = self.message_modulus

        def wrapped(x):
            return f((x // factor) % msg, (x % factor) % msg)

        return BivariateLookupTable(acc=self.generate_lookup_table(wrapped),
                                    factor=factor)

    def generate_lookup_table_bivariate(self, f) -> BivariateLookupTable:
        return self.generate_lookup_table_bivariate_with_factor(
            f, self.message_modulus)

    # -- batched primitives --

    def _pbs_device(self, data: torch.Tensor, acc: torch.Tensor
                    ) -> torch.Tensor:
        """Keyswitch + bootstrap over a batch: [B, lwe_size] -> [B, k*N+1]."""
        if data.device != self.device:
            raise ValueError(f"ciphertexts are on {data.device}, the key on "
                             f"{self.device}")
        if self.is_multi_bit:
            return core.keyswitch_then_multi_bit_pbs(self.ksk, self.bsk, acc,
                                                     data)
        return core.keyswitch_then_pbs(self.ksk, self.bsk, acc, data)

    def apply_lookup_table_batch(self, batch: ShortintBatch,
                                 lut: LookupTable) -> ShortintBatch:
        out = self._pbs_device(batch.data, lut.acc)
        return ShortintBatch(
            data=out, degrees=np.full(len(batch), lut.degree, dtype=np.int64),
            message_modulus=batch.message_modulus,
            carry_modulus=batch.carry_modulus)

    def unchecked_add_batch(self, a: ShortintBatch,
                            b: ShortintBatch) -> ShortintBatch:
        return ShortintBatch(
            data=a.data + b.data, degrees=a.degrees + b.degrees,
            message_modulus=a.message_modulus,
            carry_modulus=a.carry_modulus, noise=a.noise + b.noise)

    def unchecked_scalar_mul_batch(self, a: ShortintBatch,
                                   scalars) -> ShortintBatch:
        scalars = np.broadcast_to(np.asarray(scalars, dtype=np.int64),
                                  (len(a),))
        s = torch.from_numpy(scalars.copy()).to(a.data.device)
        return ShortintBatch(
            data=a.data * s[:, None], degrees=a.degrees * scalars,
            message_modulus=a.message_modulus,
            carry_modulus=a.carry_modulus, noise=a.noise * scalars)

    def unchecked_bivariate_batch(self, a: ShortintBatch, b: ShortintBatch,
                                  blut: BivariateLookupTable
                                  ) -> ShortintBatch:
        """(ref: bivariate_pbs.rs:167-182) packed = a*factor + b, then LUT."""
        if int(b.degrees.max(initial=0)) >= blut.factor:
            raise ValueError("bivariate rhs degree must be < packing factor")
        packed = self.unchecked_add_batch(
            self.unchecked_scalar_mul_batch(a, blut.factor), b)
        return self.apply_lookup_table_batch(packed, blut.acc)


def gen_keys(params: ClassicPBSParameters | MultiBitPBSParameters,
             seed: Optional[int] = None, device="cuda"):
    """(ref: shortint/mod.rs:87 gen_keys) -> (ClientKey, ServerKey), both on
    `device`.  Nothing is cached on disk."""
    cks = ClientKey(params, seed=seed, device=device)
    return cks, ServerKey(cks)
