"""Shortint server key: lookup tables, batch primitives, degree and noise
guards, and the op families.

Port of `tfhe_tpu/shortint/server_key.py` (ref: tfhe/src/shortint/server_key/
mod.rs, and the op files add.rs, sub.rs, neg.rs, mul.rs, div_mod.rs,
bitwise_op.rs, shift.rs, comp_op.rs, scalar_*.rs, bivariate_pbs.rs).  Every
PBS reduces to `_pbs_device`: one keyswitch + PBS over a whole batch of
blocks (ref: mod.rs:783-857), in the parameter set's PBS order
(keyswitch-then-bootstrap for ciphertexts under the big key, bootstrap-then-
keyswitch under the small key) with the classic or the multi-bit blind
rotation.  On a card the rotation runs the kernels of `ops/fused_pbs.py` or
`ops/fused_multibit.py` in the schedule the key's `mode` names, or, in
mode "ntt", the CRT-NTT key layout's step loop.
The reference's XLA shape buckets have no counterpart here: PyTorch runs
eagerly at any batch size.  `gen_keys(..., cache_dir=)` keeps raw keys on
disk as the reference does.
"""

from __future__ import annotations

import fcntl
import os
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from .. import core
from ..device import resolve_device
from ..ops import fused_multibit, fused_pbs
from ..ops.torus import to_numpy, to_tensor
from ..params import (ClassicPBSParameters, MultiBitPBSParameters, PBSOrder,
                      WopbsParameters)
from .ciphertext import CheckError, Ciphertext, NOMINAL_NOISE, ShortintBatch
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
    """`mode` picks the blind rotation's schedule: for classic parameters
    one of `fused_pbs.MODES` (default "scan2") or "ntt", the CRT-NTT key
    layout on the Shoup MAC kernel (`core.CLASSIC_MODES`); for multi-bit
    ones one of `fused_multibit.MODES` (default "scan3") or "ntt", the
    multi-bit CRT-NTT key layout (`core.MULTI_BIT_MODES`); any other value
    raises.  WoPBS parameters have the classic PBS fields and make a
    classic key (its L*G up to 18 in "scan2", whose K2 takes that)."""

    def __init__(self, cks: ClientKey, _raw=None, device=None,
                 mode: Optional[str] = None):
        p = cks.params
        self.params = p
        self.device = resolve_device(device if device is not None
                                     else cks.device)
        self.message_modulus = p.message_modulus
        self.carry_modulus = p.carry_modulus
        self.max_degree = p.total_modulus - 1
        # (ref: shortint/ciphertext/mod.rs MaxNoiseLevel::from_msg_carry_modulus)
        self.max_noise_level = (p.carry_modulus * p.message_modulus - 1) // (
            p.message_modulus - 1)
        self.delta = p.delta
        self.is_multi_bit = isinstance(p, MultiBitPBSParameters)
        if self.is_multi_bit and p.torus_bits != 64:
            raise ValueError("multi-bit keys are on the 64-bit torus only")
        if self.is_multi_bit:
            self.mode = fused_multibit.MODES[0] if mode is None else mode
            core.check_multi_bit_mode(self.mode)
        else:
            self.mode = fused_pbs.MODES[0] if mode is None else mode
            core.check_classic_mode(self.mode)
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
            self.bsk = core.prepare_multi_bit_bsk(bsk, p.pbs_base_log,
                                                  p.grouping_factor, self.mode)
        else:
            self.bsk = core.prepare_classic_bsk(bsk, p.pbs_base_log,
                                                p.torus_bits, self.mode)
        self.ksk = core.prepare_ksk(ksk, p.ks_base_log)
        self._lut_cache: dict = {}
        self.ciphertext_lwe_size = p.ciphertext_lwe_size

    @classmethod
    def from_raw(cls, params: ClassicPBSParameters | MultiBitPBSParameters
                 | WopbsParameters, bsk, ksk, device="cuda",
                 mode: Optional[str] = None) -> "ServerKey":
        """Rebuild a server key from raw standard-domain BSK / KSK arrays
        (numpy uint64 or int64 tensors); a multi-bit BSK is
        [n/gf, 2^gf, L, G, G, N]."""
        shell = ClientKey.__new__(ClientKey)
        shell.params = params
        return cls(shell, _raw=(bsk, ksk), device=device, mode=mode)

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
        """One keyswitch + PBS over a batch, in the parameters' PBS order:
        [B, lwe_size] -> [B, lwe_size].  acc is one LUT [G, N] or one per
        element [B, G, N]."""
        if data.device != self.device:
            raise ValueError(f"ciphertexts are on {data.device}, the key on "
                             f"{self.device}")
        if self.params.pbs_order is PBSOrder.KEYSWITCH_BOOTSTRAP:
            fn = (core.keyswitch_then_multi_bit_pbs if self.is_multi_bit
                  else core.keyswitch_then_pbs)
        else:
            fn = (core.multi_bit_pbs_then_keyswitch if self.is_multi_bit
                  else core.pbs_then_keyswitch)
        return fn(self.ksk, self.bsk, acc, data, mode=self.mode)

    def apply_lookup_table_batch(self, batch: ShortintBatch,
                                 lut: LookupTable) -> ShortintBatch:
        out = self._pbs_device(batch.data, lut.acc)
        return ShortintBatch(
            data=out, degrees=np.full(len(batch), lut.degree, dtype=np.int64),
            message_modulus=batch.message_modulus,
            carry_modulus=batch.carry_modulus)

    def apply_many_lookup_tables_batch(self, batch: ShortintBatch,
                                       luts: list[LookupTable],
                                       selector) -> ShortintBatch:
        """Each element i evaluates luts[selector[i]]: one PBS call over the
        batch, with an accumulator per element."""
        selector = np.asarray(selector, dtype=np.int64)
        index = torch.from_numpy(selector).to(self.device)
        accs = torch.stack([lut.acc for lut in luts])[index]
        out = self._pbs_device(batch.data, accs)
        degs = np.array([luts[s].degree for s in selector], dtype=np.int64)
        return ShortintBatch(
            data=out, degrees=degs, message_modulus=batch.message_modulus,
            carry_modulus=batch.carry_modulus)

    def unchecked_add_batch(self, a: ShortintBatch,
                            b: ShortintBatch) -> ShortintBatch:
        return ShortintBatch(
            data=a.data + b.data, degrees=a.degrees + b.degrees,
            message_modulus=a.message_modulus,
            carry_modulus=a.carry_modulus, noise=a.noise + b.noise)

    def _body_addend(self, values: np.ndarray) -> torch.Tensor:
        """values * delta as u64 words (their int64 bit patterns), on the
        key's device."""
        with np.errstate(over="ignore"):
            words = values.astype(np.uint64) * np.uint64(self.delta)
        return torch.from_numpy(words.view(np.int64)).to(self.device)

    def unchecked_scalar_add_batch(self, a: ShortintBatch,
                                   scalars) -> ShortintBatch:
        scalars = np.broadcast_to(np.asarray(scalars, dtype=np.int64),
                                  (len(a),))
        data = a.data.clone()
        data[:, -1] += self._body_addend(
            scalars % (2 * self.params.total_modulus))
        return ShortintBatch(
            data=data, degrees=a.degrees + scalars,
            message_modulus=a.message_modulus, carry_modulus=a.carry_modulus,
            noise=a.noise.copy())

    def unchecked_scalar_mul_batch(self, a: ShortintBatch,
                                   scalars) -> ShortintBatch:
        scalars = np.broadcast_to(np.asarray(scalars, dtype=np.int64),
                                  (len(a),))
        s = torch.from_numpy(scalars.copy()).to(a.data.device)
        return ShortintBatch(
            data=a.data * s[:, None], degrees=a.degrees * scalars,
            message_modulus=a.message_modulus,
            carry_modulus=a.carry_modulus, noise=a.noise * scalars)

    def unchecked_neg_batch(self, a: ShortintBatch):
        """(ref: neg.rs:223-245) -> (result, correcting terms z): -a plus
        z * delta, z = ceil(degree / msg) * msg, at least msg."""
        msg = self.message_modulus
        z = np.maximum(-(-a.degrees // msg), 1) * msg
        data = 0 - a.data
        data[:, -1] += self._body_addend(z)
        return (ShortintBatch(data=data, degrees=z,
                              message_modulus=a.message_modulus,
                              carry_modulus=a.carry_modulus,
                              noise=a.noise.copy()), z)

    def unchecked_sub_batch(self, a: ShortintBatch, b: ShortintBatch):
        """-> (a - b with b's correcting term added, z)."""
        nb, z = self.unchecked_neg_batch(b)
        return self.unchecked_add_batch(a, nb), z

    def unchecked_bivariate_batch(self, a: ShortintBatch, b: ShortintBatch,
                                  blut: BivariateLookupTable
                                  ) -> ShortintBatch:
        """(ref: bivariate_pbs.rs:167-182) packed = a*factor + b, then LUT."""
        if int(b.degrees.max(initial=0)) >= blut.factor:
            raise ValueError("bivariate rhs degree must be < packing factor")
        packed = self.unchecked_add_batch(
            self.unchecked_scalar_mul_batch(a, blut.factor), b)
        return self.apply_lookup_table_batch(packed, blut.acc)

    def message_extract_batch(self, a: ShortintBatch) -> ShortintBatch:
        lut = self.generate_lookup_table(lambda x: x % self.message_modulus)
        return self.apply_lookup_table_batch(a, lut)

    def carry_extract_batch(self, a: ShortintBatch) -> ShortintBatch:
        lut = self.generate_lookup_table(lambda x: x // self.message_modulus)
        return self.apply_lookup_table_batch(a, lut)

    def trivial_batch(self, values, n: int) -> ShortintBatch:
        """n noiseless ciphertexts (0, ..., 0, value * delta), values reduced
        mod the total modulus."""
        p = self.params
        values = np.asarray(values, dtype=np.uint64) % np.uint64(
            p.total_modulus)
        lwe_size = self.ciphertext_lwe_size
        if n == 0:
            data = torch.zeros((0, lwe_size), dtype=torch.int64,
                               device=self.device)
        else:
            data = core.trivial_lwe(self._body_addend(values), lwe_size - 1,
                                    device=self.device)
        return ShortintBatch(
            data=data.reshape(n, lwe_size), degrees=values.astype(np.int64),
            message_modulus=p.message_modulus, carry_modulus=p.carry_modulus,
            noise=np.zeros(n, dtype=np.int64))

    # -- degree / noise guards --

    def is_add_possible(self, a: Ciphertext, b: Ciphertext) -> bool:
        return (a.degree + b.degree <= self.max_degree
                and a.noise_level + b.noise_level <= self.max_noise_level)

    def checked_add(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        if not self.is_add_possible(a, b):
            raise CheckError("degree or noise overflow in add")
        return self.unchecked_add(a, b)

    # -- one-block API over Ciphertext --

    def _b1(self, ct: Ciphertext) -> ShortintBatch:
        return ShortintBatch(
            data=ct.data[None].clone(), degrees=np.array([ct.degree]),
            message_modulus=ct.message_modulus,
            carry_modulus=ct.carry_modulus, noise=np.array([ct.noise_level]))

    def _c1(self, b: ShortintBatch, trivial: bool = False) -> Ciphertext:
        return Ciphertext(
            data=b.data[0], degree=int(b.degrees[0]),
            message_modulus=b.message_modulus, carry_modulus=b.carry_modulus,
            noise_level=int(b.noise[0]), is_trivial=trivial)

    def create_trivial(self, value: int) -> Ciphertext:
        return self._c1(self.trivial_batch(np.asarray([value]), 1),
                        trivial=True)

    def apply_lookup_table(self, ct: Ciphertext, lut_or_f) -> Ciphertext:
        lut = (lut_or_f if isinstance(lut_or_f, LookupTable)
               else self.generate_lookup_table(lut_or_f))
        return self._c1(self.apply_lookup_table_batch(self._b1(ct), lut))

    def unchecked_add(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return self._c1(self.unchecked_add_batch(self._b1(a), self._b1(b)))

    def unchecked_sub(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        out, _ = self.unchecked_sub_batch(self._b1(a), self._b1(b))
        return self._c1(out)

    def unchecked_neg(self, a: Ciphertext) -> Ciphertext:
        out, _ = self.unchecked_neg_batch(self._b1(a))
        return self._c1(out)

    def unchecked_scalar_add(self, a: Ciphertext, s: int) -> Ciphertext:
        return self._c1(self.unchecked_scalar_add_batch(self._b1(a), s))

    def unchecked_scalar_mul(self, a: Ciphertext, s: int) -> Ciphertext:
        return self._c1(self.unchecked_scalar_mul_batch(self._b1(a), s))

    def unchecked_bivariate(self, a: Ciphertext, b: Ciphertext,
                            f) -> Ciphertext:
        blut = self.generate_lookup_table_bivariate(f)
        return self._c1(
            self.unchecked_bivariate_batch(self._b1(a), self._b1(b), blut))

    def message_extract(self, a: Ciphertext) -> Ciphertext:
        return self.apply_lookup_table(a, lambda x: x % self.message_modulus)

    def carry_extract(self, a: Ciphertext) -> Ciphertext:
        return self.apply_lookup_table(a, lambda x: x // self.message_modulus)

    def _clean(self, ct: Ciphertext) -> Ciphertext:
        """Refresh a block so its carry space is empty."""
        if ct.carry_is_empty() and ct.noise_level <= NOMINAL_NOISE:
            return ct
        return self.message_extract(ct)

    def _smart_bivariate(self, a: Ciphertext, b: Ciphertext,
                         f) -> Ciphertext:
        if a.degree >= self.message_modulus or a.noise_level > NOMINAL_NOISE:
            a = self.message_extract(a)
        if b.degree >= self.message_modulus or b.noise_level > NOMINAL_NOISE:
            b = self.message_extract(b)
        return self.unchecked_bivariate(a, b, f)

    # -- the op families, each a LUT family of the reference's op files --

    def add(self, a, b):  # (ref: add.rs)
        if not self.is_add_possible(a, b):
            a, b = self._clean(a), self._clean(b)
        return self.message_extract(self.unchecked_add(a, b))

    def sub(self, a, b):  # (ref: sub.rs)
        if a.degree + ((b.degree // self.message_modulus + 1)
                       * self.message_modulus) > self.max_degree:
            a, b = self._clean(a), self._clean(b)
        return self.message_extract(self.unchecked_sub(a, b))

    def neg(self, a):  # (ref: neg.rs)
        return self.message_extract(self.unchecked_neg(a))

    def mul_lsb(self, a, b):  # (ref: mul.rs)
        m = self.message_modulus
        return self._smart_bivariate(a, b, lambda x, y: (x * y) % m)

    def mul_msb(self, a, b):
        m = self.message_modulus
        return self._smart_bivariate(a, b, lambda x, y: (x * y) // m)

    def div(self, a, b):  # (ref: div_mod.rs; division by zero yields msg-1)
        m = self.message_modulus
        return self._smart_bivariate(
            a, b, lambda x, y: (x // y) % m if y != 0 else m - 1)

    def mod_(self, a, b):
        m = self.message_modulus
        return self._smart_bivariate(
            a, b, lambda x, y: (x % y) % m if y != 0 else x % m)

    def bitand(self, a, b):  # (ref: bitwise_op.rs)
        return self._smart_bivariate(a, b, lambda x, y: x & y)

    def bitor(self, a, b):
        return self._smart_bivariate(a, b, lambda x, y: x | y)

    def bitxor(self, a, b):
        return self._smart_bivariate(a, b, lambda x, y: x ^ y)

    def scalar_left_shift(self, a, shift: int):  # (ref: shift.rs)
        m = self.message_modulus
        return self.apply_lookup_table(a, lambda x: ((x % m) << shift) % m)

    def scalar_right_shift(self, a, shift: int):
        m = self.message_modulus
        return self.apply_lookup_table(a, lambda x: (x % m) >> shift)

    # comparisons return 0/1 blocks (ref: comp_op.rs)
    def eq(self, a, b):
        return self._smart_bivariate(a, b, lambda x, y: int(x == y))

    def ne(self, a, b):
        return self._smart_bivariate(a, b, lambda x, y: int(x != y))

    def lt(self, a, b):
        return self._smart_bivariate(a, b, lambda x, y: int(x < y))

    def le(self, a, b):
        return self._smart_bivariate(a, b, lambda x, y: int(x <= y))

    def gt(self, a, b):
        return self._smart_bivariate(a, b, lambda x, y: int(x > y))

    def ge(self, a, b):
        return self._smart_bivariate(a, b, lambda x, y: int(x >= y))


def gen_keys(params: ClassicPBSParameters | MultiBitPBSParameters,
             seed: Optional[int] = None, device="cuda",
             mode: Optional[str] = None, cache_dir: Optional[str] = None):
    """(ref: shortint/mod.rs:87 gen_keys) -> (ClientKey, ServerKey), both on
    `device`, the server key's blind rotation in schedule `mode` (None: the
    key kind's default).

    With `cache_dir` and a fixed seed the raw BSK and KSK are kept on disk,
    keyed by (parameter set name, seed), in the reference's file
    (tfhe_tpu/shortint/server_key.py:468-490: the same name and arrays, so
    both packages share it) under a file lock; a hit rebuilds the server
    key on `device` and fast-forwards the encryption generator past the
    key generation, so the client key encrypts as if it had made them."""
    cks = ClientKey(params, seed=seed, device=device)
    if cache_dir is None or seed is None:
        return cks, ServerKey(cks, mode=mode)
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, f"{params.name}_s{seed}.npz")
    with open(path + ".lock", "w") as lock_f:
        fcntl.flock(lock_f, fcntl.LOCK_EX)
        try:
            if os.path.exists(path):
                with np.load(path) as data:
                    cks.enc_gen.mask.current = int(data["mask_cur"])
                    cks.enc_gen.noise.current = int(data["noise_cur"])
                    raw = (data["bsk"], data["ksk"])
                return cks, ServerKey(cks, _raw=raw, mode=mode)
            sks = ServerKey(cks, mode=mode)
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                np.savez(f, bsk=to_numpy(sks.raw_bsk),
                         ksk=to_numpy(sks.raw_ksk),
                         mask_cur=cks.enc_gen.mask.current,
                         noise_cur=cks.enc_gen.noise.current)
            os.replace(tmp, path)
            return cks, sks
        finally:
            fcntl.flock(lock_f, fcntl.LOCK_UN)
