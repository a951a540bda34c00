"""CRT (residue-number-system) integers.

Port of `tfhe_tpu/integer/crt.py` (ref: tfhe/src/integer/ciphertext/
mod.rs:426-437 BaseCrtCiphertext; server_key/crt/ + crt_parallel/;
client_key/mod.rs:523-580 encrypt_crt / decrypt_crt; client_key/utils.rs
i_crt).

A value x < prod(basis) is held as one block per basis element b_i
encrypting x % b_i with the standard parameter delta (ref: shortint/engine/
client_side.rs:58-85 encrypt_inner_ct: same delta, reduced message).  Every
op is residue-independent, so every CRT operation is one shortint batch call
over the block axis.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np

from ..params import ClassicPBSParameters
from ..shortint.ciphertext import ShortintBatch
from ..shortint.client_key import ClientKey as ShortintClientKey
from ..shortint.server_key import ServerKey as ShortintServerKey
from ..shortint.server_key import gen_keys as shortint_gen_keys


def i_crt(moduli: Sequence[int], residues: Sequence[int]) -> int:
    """Inverse CRT recomposition (ref: integer/client_key/utils.rs i_crt)."""
    whole = 1
    for m in moduli:
        whole *= int(m)
    acc = 0
    for m, r in zip(moduli, residues):
        m = int(m)
        other = whole // m
        acc += int(r) * other * pow(other, -1, m)
    return acc % whole


@dataclass
class CrtCiphertext:
    """blocks: a ShortintBatch of len(moduli) residue blocks."""

    blocks: ShortintBatch
    moduli: List[int]

    def copy(self) -> "CrtCiphertext":
        return CrtCiphertext(self.blocks.copy(), list(self.moduli))

    def _conformance_check(self, params) -> None:
        self.blocks._conformance_check(params)


class CrtClientKey:
    """(ref: integer/client_key/mod.rs CrtClientKey)"""

    def __init__(self, params: ClassicPBSParameters, basis: Sequence[int],
                 seed: Optional[int] = None,
                 key: Optional[ShortintClientKey] = None, device="cuda"):
        for b in basis:
            if b > params.total_modulus:
                raise ValueError(f"basis element {b} exceeds block space "
                                 f"{params.total_modulus}")
        self.params = params
        self.basis = [int(b) for b in basis]
        self.key = key if key is not None else ShortintClientKey(
            params, seed=seed, device=device)

    @property
    def modulus(self) -> int:
        m = 1
        for b in self.basis:
            m *= b
        return m

    def encrypt(self, message: int) -> CrtCiphertext:
        message = int(message) % self.modulus
        residues = np.array([message % b for b in self.basis], dtype=np.uint64)
        batch = self.key.encrypt_batch(residues)
        batch.degrees = np.array([b - 1 for b in self.basis], dtype=np.int64)
        return CrtCiphertext(batch, list(self.basis))

    def decrypt(self, ct: CrtCiphertext) -> int:
        vals = self.key.decrypt_batch_message_and_carry(ct.blocks)
        residues = [int(v) % b for v, b in zip(vals, ct.moduli)]
        return i_crt(ct.moduli, residues)


def _neg_term(degree: int, msg_mod: int) -> int:
    """Degree of the correcting term used by shortint neg
    (ref: shortint/server_key/neg.rs z = ceil(deg/msg)*msg)."""
    return -(-degree // msg_mod) * msg_mod


class CrtServerKey:
    """Residue-parallel server ops (ref: integer/server_key/crt_parallel/:
    the rayon par_iter over blocks becomes one batched PBS call)."""

    def __init__(self, key: ShortintServerKey):
        self.key = key

    # -- helpers ------------------------------------------------------------

    def _residue_lut_batch(self, blocks: ShortintBatch, moduli: Sequence[int],
                           f: Callable[[int, int], int]) -> ShortintBatch:
        """One many-LUT PBS: block i through x -> f(x, b_i), its degree
        b_i - 1."""
        luts = [self.key.generate_lookup_table(lambda x, b=b: f(x, b))
                for b in moduli]
        out = self.key.apply_many_lookup_tables_batch(
            blocks, luts, np.arange(len(moduli)))
        out.degrees = np.array([b - 1 for b in moduli], dtype=np.int64)
        return out

    def full_extract_message_parallelized(self, ct: CrtCiphertext
                                          ) -> CrtCiphertext:
        """Reduce every block to its residue (clears carries): one many-LUT
        PBS (ref: crt/mod.rs full_extract_message_assign)."""
        return CrtCiphertext(self._residue_lut_batch(
            ct.blocks, ct.moduli, lambda x, b: x % b), list(ct.moduli))

    def _maybe_extract_two(self, a: CrtCiphertext, b: CrtCiphertext,
                           need_room: Callable[[int, int], int]):
        max_deg = self.key.max_degree
        if any(need_room(int(da), int(db)) > max_deg
               for da, db in zip(a.blocks.degrees, b.blocks.degrees)):
            a = self.full_extract_message_parallelized(a)
            b = self.full_extract_message_parallelized(b)
        return a, b

    # -- add / sub / neg ----------------------------------------------------

    def unchecked_crt_add_parallelized(self, a: CrtCiphertext,
                                       b: CrtCiphertext) -> CrtCiphertext:
        return CrtCiphertext(self.key.unchecked_add_batch(a.blocks, b.blocks),
                             list(a.moduli))

    def crt_add_parallelized(self, a: CrtCiphertext,
                             b: CrtCiphertext) -> CrtCiphertext:
        a, b = self._maybe_extract_two(a, b, lambda da, db: da + db)
        return self.unchecked_crt_add_parallelized(a, b)

    def unchecked_crt_neg_parallelized(self, a: CrtCiphertext
                                       ) -> CrtCiphertext:
        """Negation with a per-residue correcting term: z_i is the smallest
        multiple of b_i covering the degree, so -x + z_i stays congruent to
        -x mod b_i (ref: shortint/server_key/neg.rs:223-245 with the block's
        own message modulus, which for CRT blocks is the basis element)."""
        moduli = np.array(a.moduli, dtype=np.int64)
        z = np.maximum(-(-a.blocks.degrees // moduli), 1) * moduli
        data = 0 - a.blocks.data
        data[:, -1] += self.key._body_addend(z)
        return CrtCiphertext(ShortintBatch(
            data=data, degrees=z, message_modulus=a.blocks.message_modulus,
            carry_modulus=a.blocks.carry_modulus,
            noise=a.blocks.noise.copy()), list(a.moduli))

    def crt_neg_parallelized(self, a: CrtCiphertext) -> CrtCiphertext:
        return self.unchecked_crt_neg_parallelized(a)

    def unchecked_crt_sub_parallelized(self, a: CrtCiphertext,
                                       b: CrtCiphertext) -> CrtCiphertext:
        return self.unchecked_crt_add_parallelized(
            a, self.unchecked_crt_neg_parallelized(b))

    def crt_sub_parallelized(self, a: CrtCiphertext,
                             b: CrtCiphertext) -> CrtCiphertext:
        # neg's correcting term needs the degree room of an add
        a, b = self._maybe_extract_two(
            a, b, lambda da, db: da + _neg_term(db, max(a.moduli)))
        return self.unchecked_crt_sub_parallelized(a, b)

    # -- mul ----------------------------------------------------------------

    def unchecked_crt_mul_parallelized(self, a: CrtCiphertext,
                                       b: CrtCiphertext) -> CrtCiphertext:
        """Per-residue bivariate PBS (x*y) % b_i: residues are packed with
        their own basis factor (lhs_i * b_i + rhs_i) and evaluated by one
        many-LUT PBS (ref: crt_parallel/mul_crt.rs)."""
        packed = self.key.unchecked_add_batch(
            self.key.unchecked_scalar_mul_batch(
                a.blocks, np.array(a.moduli, dtype=np.int64)), b.blocks)
        return CrtCiphertext(self._residue_lut_batch(
            packed, a.moduli, lambda x, b_: ((x // b_) * (x % b_)) % b_),
            list(a.moduli))

    def crt_mul_parallelized(self, a: CrtCiphertext,
                             b: CrtCiphertext) -> CrtCiphertext:
        max_deg = self.key.max_degree
        if any(int(da) * b_ + int(db) > max_deg for da, db, b_ in
               zip(a.blocks.degrees, b.blocks.degrees, a.moduli)):
            a = self.full_extract_message_parallelized(a)
            b = self.full_extract_message_parallelized(b)
        return self.unchecked_crt_mul_parallelized(a, b)

    # -- scalar variants ----------------------------------------------------

    def unchecked_crt_scalar_add_parallelized(self, a: CrtCiphertext,
                                              scalar: int) -> CrtCiphertext:
        scalars = np.array([scalar % b for b in a.moduli], dtype=np.uint64)
        return CrtCiphertext(
            self.key.unchecked_scalar_add_batch(a.blocks, scalars),
            list(a.moduli))

    def crt_scalar_add_parallelized(self, a, scalar: int):
        if any(int(d) + (scalar % b) > self.key.max_degree
               for d, b in zip(a.blocks.degrees, a.moduli)):
            a = self.full_extract_message_parallelized(a)
        return self.unchecked_crt_scalar_add_parallelized(a, scalar)

    def crt_scalar_sub_parallelized(self, a: CrtCiphertext,
                                    scalar: int) -> CrtCiphertext:
        whole = 1
        for b in a.moduli:
            whole *= b
        return self.crt_scalar_add_parallelized(a, (-scalar) % whole)

    def unchecked_crt_scalar_mul_parallelized(self, a: CrtCiphertext,
                                              scalar: int) -> CrtCiphertext:
        scalars = np.array([scalar % b for b in a.moduli], dtype=np.uint64)
        return CrtCiphertext(
            self.key.unchecked_scalar_mul_batch(a.blocks, scalars),
            list(a.moduli))

    def crt_scalar_mul_parallelized(self, a: CrtCiphertext,
                                    scalar: int) -> CrtCiphertext:
        if any(int(d) * (scalar % b) > self.key.max_degree
               for d, b in zip(a.blocks.degrees, a.moduli)):
            a = self.full_extract_message_parallelized(a)
        out = self.unchecked_crt_scalar_mul_parallelized(a, scalar)
        return self.full_extract_message_parallelized(out)

    # -- programmable function ----------------------------------------------

    def pbs_crt_compliant_function_parallelized(
            self, a: CrtCiphertext, f: Callable[[int], int]) -> CrtCiphertext:
        """Evaluate a residue-compatible function f per block
        (ref: crt/mod.rs pbs_crt_compliant_function_assign)."""
        return CrtCiphertext(self._residue_lut_batch(
            a.blocks, a.moduli, lambda x, b: f(x) % b), list(a.moduli))


def gen_keys_crt(params: ClassicPBSParameters, basis: Sequence[int],
                 seed: Optional[int] = None, device="cuda",
                 cache_dir: Optional[str] = None):
    """(ref: integer/mod.rs gen_keys_crt) -> (CrtClientKey, CrtServerKey) on
    `device`; `cache_dir` as `shortint.gen_keys`."""
    scks, ssks = shortint_gen_keys(params, seed=seed, device=device,
                                   cache_dir=cache_dir)
    return CrtClientKey(params, basis, key=scks), CrtServerKey(ssks)
