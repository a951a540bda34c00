"""Shortint WoPBS key: large-LUT evaluation without the padding bit.

Port of `tfhe_tpu/shortint/wopbs.py` (ref: tfhe/src/shortint/wopbs/mod.rs —
WopbsKey :43-50 and its generate_lut :282-300 / wopbs :434-452 /
extract_bits :547-627 / circuit_bootstrapping_vertical_packing :630-700).

The `new_wopbs_key_only_for_wopbs` flavour: the compute parameters are the
WoPBS parameters, so no casting keyswitch is needed.  The server key's PBS
(extraction and the circuit bootstrap's shifts) runs in its `mode`; the
pfpksk list lives on the key's device.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from ..core import wopbs as wop
from ..ops.torus import to_tensor
from ..params import WopbsParameters
from .ciphertext import Ciphertext, ShortintBatch
from .client_key import ClientKey
from .server_key import ServerKey


class ShortintWopbsLUT:
    """A clear LUT as a polynomial list [count, N] uint64 on the host
    (ref: shortint/wopbs/mod.rs ShortintWopbsLUT)."""

    def __init__(self, polys: np.ndarray, output_degree: int):
        self.polys = np.asarray(polys, dtype=np.uint64)
        self.output_degree = output_degree


class WopbsKey:
    def __init__(self, cks: ClientKey, sks: ServerKey,
                 _pfpksk: Optional[torch.Tensor] = None):
        p = cks.params
        if not isinstance(p, WopbsParameters):
            raise TypeError("WopbsKey needs WopbsParameters")
        self.params = p
        self.server_key = sks
        pfpksk = _pfpksk if _pfpksk is not None else \
            wop.generate_cbs_pfpksk_list(
                cks.big_sk, cks.glwe_sk, p.pfks_base_log, p.pfks_level,
                p.pfks_modular_std_dev, cks.enc_gen)
        self.cbs = wop.CircuitBootstrapper(
            bsk_prepared=sks.bsk,
            ksk_prepared=sks.ksk,
            pfpksk_list=pfpksk.to(sks.device),
            pfks_base_log=p.pfks_base_log,
            pfks_levels=p.pfks_level,
            cbs_base_log=p.cbs_base_log,
            cbs_levels=p.cbs_level,
            mode=sks.mode,
        )

    @classmethod
    def from_raw(cls, params: WopbsParameters, sks: ServerKey,
                 pfpksk) -> "WopbsKey":
        """A WoPBS key from a server key and a raw pfpksk list
        [G, k*N+1, pfks_level, G, N] (numpy uint64 or an int64 tensor)."""
        shell = ClientKey.__new__(ClientKey)
        shell.params = params
        if not isinstance(pfpksk, torch.Tensor):
            pfpksk = to_tensor(np.asarray(pfpksk, np.uint64), sks.device)
        return cls(shell, sks, _pfpksk=pfpksk)

    # -- LUT construction (ref: wopbs/mod.rs:282-300) -----------------------

    @property
    def _nb_bits(self) -> int:
        return int(math.log2(self.params.total_modulus))

    def _lut(self, f: Callable[[int], int], full_domain: bool
             ) -> ShortintWopbsLUT:
        p = self.params
        total = p.total_modulus
        poly = np.zeros(p.polynomial_size, dtype=np.uint64)
        delta_log = p.delta.bit_length() - 1
        max_out = 0
        for i in range(2 ** self._nb_bits):
            v = int(f(i if full_domain else i % p.message_modulus)) % total
            max_out = max(max_out, v)
            poly[i] = np.uint64(v) << np.uint64(delta_log)
        return ShortintWopbsLUT(poly[None, :], output_degree=max_out)

    def generate_lut(self, f: Callable[[int], int]) -> ShortintWopbsLUT:
        """LUT over the full message+carry space, f of the message, encoded
        at the shortint delta (one padding bit)."""
        return self._lut(f, full_domain=False)

    def generate_lut_full_domain(self, f: Callable[[int], int]
                                 ) -> ShortintWopbsLUT:
        """LUT indexed by the full (message, carry) packed value."""
        return self._lut(f, full_domain=True)

    # -- the WoPBS itself (ref: wopbs/mod.rs:434-452) -----------------------

    def extract_bits_batch(self, batch: ShortintBatch, delta_log: int,
                           n_bits: int) -> torch.Tensor:
        """[B] blocks -> [B, n_bits, n_small+1] bit LWEs, MSB first."""
        sks = self.server_key
        return wop.extract_bits(sks.bsk, sks.ksk, batch.data, delta_log,
                                n_bits, sks.mode)

    def wopbs_batch(self, batch: ShortintBatch,
                    lut: ShortintWopbsLUT) -> ShortintBatch:
        """The LUT on every block: extract bits -> circuit bootstrap ->
        vertical packing."""
        p = self.params
        delta_log = p.delta.bit_length() - 1
        n_bits = self._nb_bits
        bits = self.extract_bits_batch(batch, delta_log, n_bits)
        ggsw_list = [self.cbs.circuit_bootstrap(bits[:, j], 63)
                     for j in range(n_bits)]
        out = wop.vertical_packing(lut.polys, ggsw_list, p.glwe_size,
                                   p.cbs_base_log, p.cbs_level)
        return ShortintBatch(
            data=out,
            degrees=np.full(len(batch), lut.output_degree, dtype=np.int64),
            message_modulus=batch.message_modulus,
            carry_modulus=batch.carry_modulus)

    def wopbs(self, ct: Ciphertext, lut: ShortintWopbsLUT) -> Ciphertext:
        b = ShortintBatch(data=ct.data[None], degrees=np.array([ct.degree]),
                          message_modulus=ct.message_modulus,
                          carry_modulus=ct.carry_modulus)
        out = self.wopbs_batch(b, lut)
        return Ciphertext(data=out.data[0], degree=int(out.degrees[0]),
                          message_modulus=ct.message_modulus,
                          carry_modulus=ct.carry_modulus)


def gen_keys_wopbs(params: WopbsParameters, seed: Optional[int] = None,
                   device="cuda", mode: Optional[str] = None):
    """(ref: shortint/wopbs doc examples: gen_keys + WopbsKey) ->
    (ClientKey, ServerKey, WopbsKey) on `device`; the server key's blind
    rotation in schedule `mode` (None: "scan2")."""
    cks = ClientKey(params, seed=seed, device=device)
    sks = ServerKey(cks, mode=mode)
    return cks, sks, WopbsKey(cks, sks)
