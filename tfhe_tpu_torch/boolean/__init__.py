"""FHE boolean gates over the u32 torus (port of `tfhe_tpu/boolean/__init__.py`;
ref: tfhe/src/boolean/).

Encoding: true = 1/8 (2^29), false = -1/8 (7*2^29) (ref: boolean/mod.rs:74-80).
A binary gate is a linear combination of input LWE ciphertexts followed by a
sign-test bootstrap whose accumulator body is the constant 1/8 polynomial
(ref: boolean/engine/bootstrapping.rs:60), and a keyswitch in the order the
parameter set dictates (`params.pbs_order`).

Ciphertexts are int64 tensors of u32 words ([n+1], or [B, n+1] for a batch)
on the keys' device.  Every gate has a batched form (one keyswitch + PBS over
the whole batch) and a scalar form with the reference's trivial-ciphertext
dispatch.  The blind rotation runs in the schedule the server key's `mode`
names (`core.CLASSIC_MODES`: the six of `ops.fused_pbs.MODES`, the port's
explicit counterpart of the reference's global TFHE_TPU_FUSED_MODE, and
"ntt", the CRT-NTT key layout the reference runs off the TPU); every
schedule gives the same words.

`PublicKey` (tfhe_tpu/boolean/__init__.py:251-277) encrypts through
`core/public_key.py` on the u32 torus.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import core
from ..device import resolve_device
from ..ops.torus import MASK32, to_tensor
from ..params import (DEFAULT_PARAMETERS, BooleanParameters,
                      EncryptionKeyChoice, PBSOrder)
from ..prng import Seeder, system_seeder
from ..prng.generators import EncryptionRandomGenerator, SecretRandomGenerator

PLAINTEXT_TRUE = 1 << 29
PLAINTEXT_FALSE = 7 << 29
BITS = 32


@dataclass
class Ciphertext:
    """Trivial (clear bool) or encrypted boolean (ref: boolean/ciphertext.rs)."""

    data: Optional[torch.Tensor] = None  # [n+1] int64 of u32 words
    trivial: Optional[bool] = None

    @property
    def is_trivial(self) -> bool:
        return self.trivial is not None


class ClientKey:
    """(ref: boolean/client_key/mod.rs)"""

    def __init__(self, params: BooleanParameters, seed: Optional[int] = None,
                 device="cuda"):
        self.params = params
        self.device = resolve_device(device)
        seeder = Seeder(seed) if seed is not None else system_seeder()
        sec = SecretRandomGenerator(seeder.seed())
        self.enc_gen = EncryptionRandomGenerator(seeder.seed(), seeder)
        self.lwe_sk = core.generate_binary_lwe_secret_key(
            params.lwe_dimension, sec, bits=BITS, device=self.device)
        self.glwe_sk = core.generate_binary_glwe_secret_key(
            params.glwe_dimension, params.polynomial_size, sec, bits=BITS,
            device=self.device)
        self.big_sk = self.glwe_sk.as_lwe_secret_key()

    @classmethod
    def from_raw(cls, params: BooleanParameters, lwe_sk_bits, glwe_sk_bits,
                 seed: Optional[int] = None, device="cuda") -> "ClientKey":
        """Rebuild a client key from stored secret-key bits [n] and [k, N];
        encryption randomness is seeded afresh."""
        self = cls.__new__(cls)
        self.params = params
        self.device = resolve_device(device)
        seeder = Seeder(seed) if seed is not None else system_seeder()
        self.enc_gen = EncryptionRandomGenerator(seeder.seed(), seeder)
        self.lwe_sk = core.LweSecretKey(
            to_tensor(np.asarray(lwe_sk_bits, np.uint64), self.device),
            bits=BITS)
        self.glwe_sk = core.GlweSecretKey(
            to_tensor(np.asarray(glwe_sk_bits, np.uint64), self.device),
            bits=BITS)
        self.big_sk = self.glwe_sk.as_lwe_secret_key()
        return self

    @property
    def encryption_sk(self):
        if self.params.encryption_key_choice is EncryptionKeyChoice.SMALL:
            return self.lwe_sk, self.params.lwe_modular_std_dev
        return self.big_sk, self.params.glwe_modular_std_dev

    def encrypt(self, message: bool) -> Ciphertext:
        return Ciphertext(data=self.encrypt_batch([message])[0])

    def encrypt_batch(self, messages) -> torch.Tensor:
        """[B] bools -> [B, n+1] ciphertexts."""
        messages = np.asarray(messages, dtype=bool)
        encoded = np.where(messages, PLAINTEXT_TRUE, PLAINTEXT_FALSE).astype(
            np.uint32)
        sk, std = self.encryption_sk
        return core.encrypt_lwe(sk, encoded, std, self.enc_gen)

    def decrypt(self, ct: Ciphertext) -> bool:
        if ct.is_trivial:
            return ct.trivial
        return bool(self.decrypt_batch(ct.data[None])[0])

    def decrypt_batch(self, data: torch.Tensor) -> np.ndarray:
        sk, _ = self.encryption_sk
        phase = core.decrypt_lwe(sk, data)
        return (phase < 1 << 31).cpu().numpy()


def _add_constant(x: torch.Tensor, c: int) -> torch.Tensor:
    """x + c * (0, ..., 0, 1) mod 2^32: adds a plaintext to the body."""
    out = x.clone()
    out[..., -1] += c
    return out & MASK32


class ServerKey:
    """BSK (small -> GLWE) + KSK (big -> small) (ref: boolean/server_key).

    `mode` picks the blind rotation's schedule for every gate.  The raw
    standard-domain keys stay in `raw_bsk` / `raw_ksk`, so a key of another
    mode can be rebuilt from them with `from_raw`."""

    def __init__(self, cks: ClientKey, device=None, mode: str = "scan2",
                 _raw=None):
        core.check_classic_mode(mode)
        p = cks.params
        self.params = p
        self.mode = mode
        self.device = resolve_device(device if device is not None
                                     else cks.device)
        if _raw is None:
            bsk = core.generate_bootstrap_key(
                cks.lwe_sk, cks.glwe_sk, p.pbs_base_log, p.pbs_level,
                p.glwe_modular_std_dev, cks.enc_gen)
            ksk = core.generate_keyswitch_key(
                cks.big_sk, cks.lwe_sk, p.ks_base_log, p.ks_level,
                p.lwe_modular_std_dev, cks.enc_gen)
        else:
            bsk, ksk = (k if isinstance(k, torch.Tensor)
                        else to_tensor(np.asarray(k), self.device)
                        for k in _raw)
        self.raw_bsk = bsk.to(device=self.device, dtype=torch.int64)
        self.raw_ksk = ksk.to(device=self.device, dtype=torch.int64)
        self.bsk = core.prepare_classic_bsk(self.raw_bsk, p.pbs_base_log,
                                            BITS, mode)
        self.ksk = core.prepare_ksk(self.raw_ksk, p.ks_base_log, bits=BITS)
        self.accumulator = torch.zeros((p.glwe_size, p.polynomial_size),
                                       dtype=torch.int64, device=self.device)
        self.accumulator[-1] = PLAINTEXT_TRUE

    @classmethod
    def from_raw(cls, params: BooleanParameters, bsk, ksk, device="cuda",
                 mode: str = "scan2") -> "ServerKey":
        """Rebuild a server key from raw standard-domain keys (numpy uint32
        or uint64, or int64 tensors of u32 words): bsk [n, L, G, G, N], ksk
        [k*N, ks_level, n+1]."""
        shell = ClientKey.__new__(ClientKey)
        shell.params = params
        return cls(shell, device=device, mode=mode, _raw=(bsk, ksk))

    # -- the bootstrapping pattern (ref: engine/bootstrapping.rs
    #    apply_bootstrapping_pattern) --

    def _bootstrap_pattern(self, lin_comb: torch.Tensor) -> torch.Tensor:
        if lin_comb.device != self.device:
            raise ValueError(f"ciphertexts are on {lin_comb.device}, the key "
                             f"on {self.device}")
        ct = torch.atleast_2d(lin_comb)
        if self.params.pbs_order is PBSOrder.KEYSWITCH_BOOTSTRAP:
            return core.keyswitch_then_pbs(self.ksk, self.bsk,
                                           self.accumulator, ct, self.mode)
        return core.pbs_then_keyswitch(self.ksk, self.bsk, self.accumulator,
                                       ct, self.mode)

    # -- batched gates --

    def and_batch(self, a, b):
        return self._bootstrap_pattern(_add_constant(a + b, PLAINTEXT_FALSE))

    def or_batch(self, a, b):
        return self._bootstrap_pattern(_add_constant(a + b, PLAINTEXT_TRUE))

    def nand_batch(self, a, b):
        return self._bootstrap_pattern(_add_constant(-(a + b), PLAINTEXT_TRUE))

    def nor_batch(self, a, b):
        return self._bootstrap_pattern(_add_constant(-(a + b),
                                                     PLAINTEXT_FALSE))

    def xor_batch(self, a, b):
        return self._bootstrap_pattern(
            2 * _add_constant(a + b, PLAINTEXT_TRUE) & MASK32)

    def xnor_batch(self, a, b):
        return self._bootstrap_pattern(
            2 * _add_constant(-(a + b), PLAINTEXT_FALSE) & MASK32)

    def not_batch(self, a):
        return -a & MASK32

    def mux_batch(self, cond, then_ct, else_ct):
        """(ref: boolean/engine/mod.rs:461-570 mux).  The reference's two
        bootstraps run as one batch of 2B."""
        t1 = _add_constant(cond + then_ct, PLAINTEXT_FALSE)
        t2 = _add_constant(-cond + else_ct, PLAINTEXT_FALSE)
        both = self._bootstrap_pattern(torch.cat([torch.atleast_2d(t1),
                                                  torch.atleast_2d(t2)]))
        p1, p2 = both.chunk(2)
        return _add_constant(p1 + p2, PLAINTEXT_TRUE)

    # -- scalar gate API with trivial-ciphertext dispatch (ref semantics) --

    def _binary_gate(self, a: Ciphertext, b: Ciphertext, batch_fn, clear_fn,
                     mixed_fn):
        if a.is_trivial and b.is_trivial:
            return Ciphertext(trivial=clear_fn(a.trivial, b.trivial))
        if a.is_trivial or b.is_trivial:
            enc, clear = (b, a.trivial) if a.is_trivial else (a, b.trivial)
            return mixed_fn(enc, clear)
        return Ciphertext(data=batch_fn(a.data[None], b.data[None])[0])

    def and_(self, a, b):
        return self._binary_gate(
            a, b, self.and_batch, lambda x, y: x and y,
            lambda enc, clear: (Ciphertext(data=enc.data.clone()) if clear
                                else Ciphertext(trivial=False)))

    def or_(self, a, b):
        return self._binary_gate(
            a, b, self.or_batch, lambda x, y: x or y,
            lambda enc, clear: (Ciphertext(trivial=True) if clear
                                else Ciphertext(data=enc.data.clone())))

    def nand(self, a, b):
        return self.not_(self.and_(a, b))

    def nor(self, a, b):
        return self.not_(self.or_(a, b))

    def xor(self, a, b):
        return self._binary_gate(
            a, b, self.xor_batch, lambda x, y: x != y,
            lambda enc, clear: (self.not_(enc) if clear
                                else Ciphertext(data=enc.data.clone())))

    def xnor(self, a, b):
        return self.not_(self.xor(a, b))

    def not_(self, a: Ciphertext) -> Ciphertext:
        if a.is_trivial:
            return Ciphertext(trivial=not a.trivial)
        return Ciphertext(data=self.not_batch(a.data))

    def mux(self, cond: Ciphertext, then_ct: Ciphertext, else_ct: Ciphertext):
        if cond.is_trivial:
            return then_ct if cond.trivial else else_ct
        if then_ct.is_trivial:
            return (self.or_(cond, else_ct) if then_ct.trivial
                    else self.and_(self.not_(cond), else_ct))
        if else_ct.is_trivial:
            return (self.or_(then_ct, self.not_(cond)) if else_ct.trivial
                    else self.and_(cond, then_ct))
        return Ciphertext(data=self.mux_batch(
            cond.data[None], then_ct.data[None], else_ct.data[None])[0])

    def trivial_encrypt(self, value: bool) -> Ciphertext:
        return Ciphertext(trivial=value)


class PublicKey:
    """Boolean public key: a zero-encryption list over the u32 torus, on
    the client key's device (ref: tfhe/src/boolean/public_key/mod.rs;
    tfhe_tpu/boolean/__init__.py:251-277)."""

    def __init__(self, cks: ClientKey):
        from ..core import public_key as core_pk

        self.params = cks.params
        sk, std = cks.encryption_sk
        count = core_pk.public_key_zero_encryption_count(
            sk.lwe_dimension + 1, bits=BITS)
        self.key = core_pk.generate_lwe_public_key(sk, count, std,
                                                   cks.enc_gen)

    def encrypt_batch(self, messages,
                      seed: Optional[int] = None) -> torch.Tensor:
        """[B] bools -> [B, n+1] ciphertexts; the choices from a fresh
        generator (seeded by `seed`, else by the system)."""
        from ..core import public_key as core_pk

        seeder = Seeder(seed) if seed is not None else system_seeder()
        sec = SecretRandomGenerator(seeder.seed())
        messages = np.asarray(messages, dtype=bool)
        encoded = np.where(messages, PLAINTEXT_TRUE, PLAINTEXT_FALSE).astype(
            np.uint32)
        return core_pk.encrypt_lwe_with_public_key(self.key, encoded, sec)

    def encrypt(self, message: bool,
                seed: Optional[int] = None) -> Ciphertext:
        return Ciphertext(data=self.encrypt_batch([message], seed=seed)[0])


def gen_keys(params: BooleanParameters = DEFAULT_PARAMETERS,
             seed: Optional[int] = None, device="cuda", mode: str = "scan2"):
    """(ref: boolean/mod.rs gen_keys) -> (ClientKey, ServerKey), both on
    `device`; the server key's gates run in schedule `mode`."""
    cks = ClientKey(params, seed=seed, device=device)
    return cks, ServerKey(cks, mode=mode)
