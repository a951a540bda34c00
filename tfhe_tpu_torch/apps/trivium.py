"""FHE Trivium and Kreyvium stream ciphers + transciphering.

Port of `tfhe_tpu/apps/trivium.py` (ref: apps/trivium/src/
{trivium/trivium_bool.rs, kreyvium/kreyvium.rs, trans_ciphering/}).

Trivium's taps allow 64 consecutive steps to be computed independently
from the current registers (the reference exploits this with 64 rayon
tasks, ref: trivium_bool.rs get_64_output_and_values:189-198).  Here each
64-step wave is ~14 *batched* boolean gate calls over 64 lanes — the whole
wave is a handful of fused PBS batches instead of 64x5 scalar gates.

Both ciphers run over a pluggable bit backend, and their registers are
tensors in either (reversed with `torch.flip`, joined with `torch.cat`):
- ClearBits: plain bool tensors on the CPU (validated against the public
  avr-crypto-lib test vectors, same source as the reference's tests)
- FheBits: batched boolean-scheme gates (tfhe_tpu_torch.boolean); every
  register is an int64 tensor [n, lwe_size] of u32 words on the key's
  device, and the keystream is decrypted only where the caller asks

Transciphering: the client streams data XORed with a clear Trivium
keystream; the server XORs in the homomorphic keystream to obtain
encrypted plaintext bits without ever seeing them
(ref: apps/trivium/src/trans_ciphering/).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..boolean import ClientKey, ServerKey, PLAINTEXT_FALSE, PLAINTEXT_TRUE


# ---------------------------------------------------------------------------
# bit backends
# ---------------------------------------------------------------------------


class ClearBits:
    """Plain bool tensors [n] on the CPU — the reference's
    TriviumStream<bool>."""

    def const(self, values) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values, dtype=bool))

    def xor(self, a, b):
        return a ^ b

    def and_(self, a, b):
        return a & b


class FheBits:
    """Encrypted bits as ciphertext rows [n, lwe_size] on the key's device,
    with batched gates."""

    def __init__(self, sks: ServerKey):
        self.sks = sks
        self.device = sks.device
        from ..params import EncryptionKeyChoice

        p = sks.params
        if p.encryption_key_choice is EncryptionKeyChoice.SMALL:
            self.lwe_size = p.lwe_dimension + 1
        else:
            self.lwe_size = p.big_lwe_dimension + 1

    def const(self, values) -> torch.Tensor:
        """Trivial encryptions of clear bits, made on the device."""
        bits = torch.as_tensor(np.asarray(values, dtype=bool)).to(self.device)
        out = torch.zeros((bits.shape[0], self.lwe_size), dtype=torch.int64,
                          device=self.device)
        out[:, -1] = torch.where(bits, PLAINTEXT_TRUE, PLAINTEXT_FALSE)
        return out

    def xor(self, a, b):
        return self.sks.xor_batch(a, b)

    def and_(self, a, b):
        return self.sks.and_batch(a, b)


def _flip(reg: torch.Tensor) -> torch.Tensor:
    """The register's bits in reverse order."""
    return torch.flip(reg, dims=[0])


# ---------------------------------------------------------------------------
# the ciphers
# ---------------------------------------------------------------------------


class TriviumStream:
    """64-bits-per-wave Trivium.  State registers (newest first):
    a = s1..s93, b = s94..s177, c = s178..s288; key/iv load reversed
    (key[i] -> s_{80-i}), matching the avr-crypto-lib vector convention
    used by the reference's tests (ref: trivium/test.rs:66-101)."""

    WARMUP_WAVES = 18  # 18 * 64 = 1152 init steps

    def __init__(self, ops, key_bits: torch.Tensor, iv_bits: List[int]):
        """key_bits: backend bits [80]; iv_bits: clear list of 80 ints."""
        self.ops = ops
        zero13 = ops.const([0] * 13)
        self.a = torch.cat([_flip(key_bits), zero13])
        iv_rev = list(iv_bits)[::-1]
        self.b = ops.const(iv_rev + [0] * 4)
        c_clear = [0] * 111
        c_clear[108] = c_clear[109] = c_clear[110] = 1  # s286..s288
        self.c = ops.const(c_clear)
        for _ in range(self.WARMUP_WAVES):
            self.next_64()

    # register layout: x[0] is s_{offset+1} (the newest bit)

    def _taps(self, reg: torch.Tensor, idx: int) -> torch.Tensor:
        """[64] tap vector reg[idx - n] for n = 0..63 (wave order)."""
        return _flip(reg[idx - 63:idx + 1])

    def next_64(self) -> torch.Tensor:
        """One wave: 64 keystream bits + register update, all batched
        (ref: trivium_bool.rs get_output_and_values:143-186)."""
        ops = self.ops
        a, b, c = self.a, self.b, self.c
        t1 = ops.xor(self._taps(a, 65), self._taps(a, 92))
        t2 = ops.xor(self._taps(b, 68), self._taps(b, 83))
        t3 = ops.xor(self._taps(c, 65), self._taps(c, 110))
        z = ops.xor(ops.xor(t1, t2), t3)
        a_and = ops.and_(self._taps(a, 90), self._taps(a, 91))
        b_and = ops.and_(self._taps(b, 81), self._taps(b, 82))
        c_and = ops.and_(self._taps(c, 108), self._taps(c, 109))
        new_a = ops.xor(t3, ops.xor(c_and, self._taps(a, 68)))
        new_b = ops.xor(t1, ops.xor(a_and, self._taps(b, 77)))
        new_c = ops.xor(t2, ops.xor(b_and, self._taps(c, 86)))
        # push the wave (newest last in wave order -> reversed at front)
        self.a = torch.cat([_flip(new_a), a[:len(a) - 64]])
        self.b = torch.cat([_flip(new_b), b[:len(b) - 64]])
        self.c = torch.cat([_flip(new_c), c[:len(c) - 64]])
        return z


class KreyviumStream(TriviumStream):
    """128-bit-key Kreyvium: Trivium plus rotating K*/IV* registers
    (ref: kreyvium/kreyvium.rs:44-186)."""

    def __init__(self, ops, key_bits: torch.Tensor, iv_bits: List[int]):
        self.ops = ops
        key_rev = _flip(key_bits)
        iv_rev = list(iv_bits)[::-1]
        self.a = key_rev[:93].clone()
        self.b = ops.const(iv_rev[:84])
        c_clear = [0] * 111
        for i in range(66):
            c_clear[44 + i] = 1  # s222..s287 = 1, s288 = 0
        c = ops.const(c_clear)
        # s178..s221 = reversed-iv[84..128]
        c[:44] = ops.const(iv_rev[84:])
        self.c = c
        # K*/IV*: consumed from index 0, rotating left each step
        self.kstar = key_rev.clone()
        self.ivstar = ops.const(iv_rev)
        for _ in range(self.WARMUP_WAVES):
            self.next_64()

    def next_64(self) -> torch.Tensor:
        ops = self.ops
        a, b, c = self.a, self.b, self.c
        ks64 = self.kstar[:64]
        iv64 = self.ivstar[:64]
        t1 = ops.xor(self._taps(a, 65), self._taps(a, 92))
        t2 = ops.xor(self._taps(b, 68), self._taps(b, 83))
        t3 = ops.xor(ops.xor(self._taps(c, 65), self._taps(c, 110)), ks64)
        z = ops.xor(ops.xor(t1, t2), t3)
        a_and = ops.and_(self._taps(a, 90), self._taps(a, 91))
        b_and = ops.and_(self._taps(b, 81), self._taps(b, 82))
        c_and = ops.and_(self._taps(c, 108), self._taps(c, 109))
        new_a = ops.xor(t3, ops.xor(c_and, self._taps(a, 68)))
        new_b = ops.xor(ops.xor(t1, iv64),
                        ops.xor(a_and, self._taps(b, 77)))
        new_c = ops.xor(t2, ops.xor(b_and, self._taps(c, 86)))
        self.a = torch.cat([_flip(new_a), a[:len(a) - 64]])
        self.b = torch.cat([_flip(new_b), b[:len(b) - 64]])
        self.c = torch.cat([_flip(new_c), c[:len(c) - 64]])
        self.kstar = torch.cat([self.kstar[64:], self.kstar[:64]])
        self.ivstar = torch.cat([self.ivstar[64:], self.ivstar[:64]])
        return z


# ---------------------------------------------------------------------------
# convenience constructors + transciphering
# ---------------------------------------------------------------------------


def trivium_clear(key: List[int], iv: List[int]) -> TriviumStream:
    ops = ClearBits()
    return TriviumStream(ops, ops.const(key), iv)


def trivium_fhe(cks: ClientKey, sks: ServerKey, key: List[int],
                iv: List[int]) -> TriviumStream:
    """Key bits are encrypted; IV is public (ref: trivium_bool.rs:60-95)."""
    ops = FheBits(sks)
    enc_key = cks.encrypt_batch(np.asarray(key, dtype=bool))
    return TriviumStream(ops, enc_key, iv)


def kreyvium_clear(key: List[int], iv: List[int]) -> KreyviumStream:
    ops = ClearBits()
    return KreyviumStream(ops, ops.const(key), iv)


def kreyvium_fhe(cks: ClientKey, sks: ServerKey, key: List[int],
                 iv: List[int]) -> KreyviumStream:
    ops = FheBits(sks)
    enc_key = cks.encrypt_batch(np.asarray(key, dtype=bool))
    return KreyviumStream(ops, enc_key, iv)


def trans_decrypt_64(sks: ServerKey, stream: TriviumStream,
                     masked_bits: List[int]) -> torch.Tensor:
    """Server-side transciphering of one 64-bit word: the client sent
    data XOR clear-keystream; XORing the FHE keystream yields encrypted
    plaintext bits (ref: apps/trivium/src/trans_ciphering/)."""
    if not isinstance(stream.ops, FheBits):
        raise TypeError("transciphering needs an FHE stream")
    ks = stream.next_64()
    trivial = stream.ops.const(masked_bits)
    return stream.ops.xor(trivial, ks)
