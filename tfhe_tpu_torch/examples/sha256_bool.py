"""SHA-256 over encrypted booleans.

Port of `tfhe_tpu/examples/sha256_bool.py` (ref: tfhe/examples/sha256_bool/
{boolean_ops.rs:1-469, sha256_function.rs:1-236}): a 32-bit word is a
[32, lwe_size] tensor of boolean LWE ciphertexts (LSB-first) on the key's
device, every gate is a *batched* boolean gate over all 32 bit lanes at
once, rotations/shifts are index moves on the device (`torch.roll`, views
into `torch.empty_like`), and additions use carry-save 3:2 compression plus a
Kogge–Schenker log-depth parallel-prefix adder — the gate-level analogue
of the reference's rayon-parallelized ladner-fischer adder, shaped so the
whole adder is O(log 32) sequential batched PBS calls rather than a 32-step
ripple chain.

The compression function is the standard FIPS 180-4 circuit; correctness is
checked against the clear circuit and hashlib in the tests.  No gate's
output leaves the device; only `decrypt_word` reads a word back.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..boolean import ClientKey, ServerKey, PLAINTEXT_FALSE, PLAINTEXT_TRUE

WORD = 32

K = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
]

H_INIT = [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
          0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19]


def _trivial_bits(values: torch.Tensor, lwe_size: int) -> torch.Tensor:
    """Clear bits (a bool tensor [B] on the target device) -> trivial
    boolean ciphertext rows [B, lwe_size] int64 (u32 words) there."""
    out = torch.zeros((values.shape[0], lwe_size), dtype=torch.int64,
                      device=values.device)
    out[:, -1] = torch.where(values, PLAINTEXT_TRUE, PLAINTEXT_FALSE)
    return out


def _word_bits_lsb(value: int) -> np.ndarray:
    return np.array([(value >> i) & 1 for i in range(WORD)], dtype=bool)


def _word_bits_on(value: int, device) -> torch.Tensor:
    """The 32 bits of `value`, LSB first, as a bool tensor made on
    `device` (a fill and a shift there: no host copy)."""
    shifts = torch.arange(WORD, dtype=torch.int64, device=device)
    word = torch.full((WORD,), value, dtype=torch.int64, device=device)
    return ((word >> shifts) & 1).bool()


class Sha256Fhe:
    """Homomorphic SHA-256 engine over a boolean server key."""

    def __init__(self, sks: ServerKey):
        self.sks = sks
        self.device = sks.device
        p = sks.params
        from ..params import EncryptionKeyChoice

        if p.encryption_key_choice is EncryptionKeyChoice.SMALL:
            self.lwe_size = p.lwe_dimension + 1
        else:
            self.lwe_size = p.big_lwe_dimension + 1
        self._gates = 0

    # -- word helpers (a word = [32, lwe_size] LSB-first) -------------------

    def trivial_word(self, value: int) -> torch.Tensor:
        return _trivial_bits(_word_bits_on(value, self.device),
                             self.lwe_size)

    def _fill(self, n: int, fill: bool) -> torch.Tensor:
        """n trivial rows of `fill`, made on the device."""
        return _trivial_bits(torch.full((n,), fill, dtype=torch.bool,
                                        device=self.device), self.lwe_size)

    def rotr(self, x: torch.Tensor, n: int) -> torch.Tensor:
        # LSB-first: (x >>> n)[i] = x[(i + n) % 32] — a pure index move.
        # Words may be stacked [..., 32, lwe]; the bit axis is -2.
        return torch.roll(x, -n, dims=-2)

    def shr(self, x: torch.Tensor, n: int) -> torch.Tensor:
        out = torch.empty_like(x)
        out[..., :WORD - n, :] = x[..., n:, :]
        out[..., WORD - n:, :] = self._fill(n, False)
        return out

    def _shift_up(self, x: torch.Tensor, n: int, fill: bool) -> torch.Tensor:
        """x << n with trivial fill (carry lanes move toward the MSB)."""
        out = torch.empty_like(x)
        out[..., n:, :] = x[..., :WORD - n, :]
        out[..., :n, :] = self._fill(n, fill)
        return out

    def _g(self, fn, *args):
        """One batched gate over arbitrarily stacked words: all leading axes
        flatten into the PBS batch — stacking K independent adds turns K
        gate calls into one K*32-lane call.  Reshapes only: no host copy."""
        self._gates += 1
        shape = args[0].shape
        flat = [a.reshape(-1, shape[-1]) for a in args]
        return fn(*flat).reshape(shape)

    # -- adders -------------------------------------------------------------

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a + b mod 2^32 via Kogge–Stone parallel prefix: 5 levels of
        batched gates instead of a 32-long ripple chain."""
        sks = self.sks
        g = self._g(sks.and_batch, a, b)
        p = self._g(sks.xor_batch, a, b)
        p0 = p
        k = 1
        while k < WORD:
            gs = self._shift_up(g, k, fill=False)
            ps = self._shift_up(p, k, fill=True)
            g = self._g(sks.or_batch, g, self._g(sks.and_batch, p, gs))
            p = self._g(sks.and_batch, p, ps)
            k *= 2
        carries = self._shift_up(g, 1, fill=False)
        return self._g(sks.xor_batch, p0, carries)

    def _csa(self, a, b, c):
        """3:2 carry-save compressor: (sum, carry<<1)."""
        sks = self.sks
        axb = self._g(sks.xor_batch, a, b)
        s = self._g(sks.xor_batch, axb, c)
        maj = self._g(
            sks.or_batch,
            self._g(sks.and_batch, a, b),
            self._g(sks.and_batch, c, axb),
        )
        return s, self._shift_up(maj, 1, fill=False)

    def add_many(self, words: List[torch.Tensor]) -> torch.Tensor:
        """Sum any number of words: carry-save tree + one prefix adder
        (the batched shape of the reference's multi-operand additions)."""
        words = list(words)
        while len(words) > 2:
            s, c = self._csa(words[0], words[1], words[2])
            words = words[3:] + [s, c]
        return self.add(words[0], words[1])

    # -- round functions ----------------------------------------------------

    def _small_sigma0(self, x):
        sks = self.sks
        return self._g(
            sks.xor_batch,
            self._g(sks.xor_batch, self.rotr(x, 7), self.rotr(x, 18)),
            self.shr(x, 3))

    def _small_sigma1(self, x):
        sks = self.sks
        return self._g(
            sks.xor_batch,
            self._g(sks.xor_batch, self.rotr(x, 17), self.rotr(x, 19)),
            self.shr(x, 10))

    def _big_sigma0(self, x):
        sks = self.sks
        return self._g(
            sks.xor_batch,
            self._g(sks.xor_batch, self.rotr(x, 2), self.rotr(x, 13)),
            self.rotr(x, 22))

    def _big_sigma1(self, x):
        sks = self.sks
        return self._g(
            sks.xor_batch,
            self._g(sks.xor_batch, self.rotr(x, 6), self.rotr(x, 11)),
            self.rotr(x, 25))

    def _ch(self, e, f, g):
        sks = self.sks
        return self._g(
            sks.xor_batch,
            self._g(sks.and_batch, e, f),
            self._g(sks.and_batch, sks.not_batch(e), g))

    def _maj(self, a, b, c):
        sks = self.sks
        return self._g(
            sks.xor_batch,
            self._g(
                sks.xor_batch,
                self._g(sks.and_batch, a, b),
                self._g(sks.and_batch, a, c)),
            self._g(sks.and_batch, b, c))

    # -- compression --------------------------------------------------------

    def compress(self, state: List[torch.Tensor],
                 block_words: List[torch.Tensor],
                 rounds: int = 64) -> List[torch.Tensor]:
        """One SHA-256 compression over 16 encrypted message words
        (ref: sha256_function.rs — the standard 64-round circuit)."""
        w = list(block_words)
        for t in range(16, rounds):
            w.append(self.add_many([
                self._small_sigma1(w[t - 2]), w[t - 7],
                self._small_sigma0(w[t - 15]), w[t - 16],
            ]))
        a, b, c, d, e, f, g, h = state
        for t in range(rounds):
            # carry-save T1's five operands down to two, then run T1's and
            # T2's prefix adders as ONE stacked 2-word gate batch
            ops = [h, self._big_sigma1(e), self._ch(e, f, g),
                   self.trivial_word(K[t]), w[t]]
            while len(ops) > 2:
                s, cy = self._csa(ops[0], ops[1], ops[2])
                ops = ops[3:] + [s, cy]
            t12 = self.add(
                torch.stack([ops[0], self._big_sigma0(a)]),
                torch.stack([ops[1], self._maj(a, b, c)]))
            t1, t2 = t12[0], t12[1]
            h, g, f = g, f, e
            # e = d + T1 and a = T1 + T2, stacked into one adder
            ea = self.add(torch.stack([d, t1]), torch.stack([t1, t2]))
            e = ea[0]
            d, c, b = c, b, a
            a = ea[1]
        # all eight feed-forward adds in one stacked batch
        out = self.add(torch.stack(state),
                       torch.stack([a, b, c, d, e, f, g, h]))
        return [out[i] for i in range(8)]


def pad_message(data: bytes) -> List[int]:
    """FIPS 180-4 padding -> list of 32-bit big-endian words (multiple of
    16)."""
    bit_len = len(data) * 8
    padded = data + b"\x80"
    while (len(padded) + 8) % 64:
        padded += b"\x00"
    padded += bit_len.to_bytes(8, "big")
    return [int.from_bytes(padded[i:i + 4], "big")
            for i in range(0, len(padded), 4)]


def encrypt_words(cks: ClientKey, words: List[int]) -> List[torch.Tensor]:
    return [cks.encrypt_batch(_word_bits_lsb(wd)) for wd in words]


def decrypt_word(cks: ClientKey, word: torch.Tensor) -> int:
    bits = cks.decrypt_batch(word)
    return int(sum(int(b) << i for i, b in enumerate(bits)))


def sha256_fhe(cks: ClientKey, sks: ServerKey, data: bytes) -> bytes:
    """Full homomorphic SHA-256 digest of `data` (encrypted bit by bit)."""
    engine = Sha256Fhe(sks)
    words = pad_message(data)
    state = [engine.trivial_word(h) for h in H_INIT]
    enc = encrypt_words(cks, words)
    for blk in range(0, len(words), 16):
        state = engine.compress(state, enc[blk:blk + 16])
    return b"".join(
        decrypt_word(cks, wd).to_bytes(4, "big") for wd in state)
