"""Batched string pattern ops: B strings at once, one keyswitch + PBS wave
per PBS round.

Port of `tfhe_tpu/strings/batched.py:25-174`.  The throughput form of the
string ops (the single-string API of server_key.py is bound by depth): B
haystacks run through one wave schedule, every PBS round covering all the
strings at once.

Clear patterns use PAIR-PACKED block equality: the two radix blocks of a
char pair pack into one PBS input (b_hi*msg + b_lo, noise level msg+1, in
contract), and one univariate LUT per clear digit pair compares it, 2 PBS
per char equality in place of 4 (ref: fhe_strings server_key/
comparisons.rs per-char eq loops).
"""

from __future__ import annotations

import numpy as np
import torch

from ..integer.fused import _const
from .client_key import NUMBER_BLOCKS


class BatchedStringOps:
    """Batched pattern matching over char-block grids [B, n, nb, lwe_size]
    of clean radix char blocks (int64 torus words on the key's device),
    FINAL padding (chars past a string's length encrypt 0)."""

    def __init__(self, sks):
        self.sks = sks
        self.msg = sks.message_modulus
        self.cap = int(sks.max_noise_level)
        self._luts = {}

    def _lut(self, key, f):
        if key not in self._luts:
            self._luts[key] = self.sks.generate_lookup_table(f)
        return self._luts[key]

    def _wave(self, data, lut_key, f):
        """One keyswitch + PBS wave over [..., sz] rows, on the device."""
        out = self.sks._pbs_device(data.reshape(-1, data.shape[-1]),
                                   self._lut(lut_key, f).acc)
        return out.reshape(data.shape)

    def _trivial_one(self, shape, device):
        one = torch.zeros(shape, dtype=torch.int64, device=device)
        one[..., -1] = self.sks.delta
        return one

    def _sum_thresh(self, bits, op: str):
        """Collapse axis 1 of 0/1 blocks: AND (== count) or OR (!= 0)."""
        while bits.shape[1] > 1:
            m = bits.shape[1]
            c = min(self.cap, m)
            pad = (-m) % c
            if pad:
                shape = (bits.shape[0], pad, bits.shape[2])
                fill = (self._trivial_one(shape, bits.device) if op == "and"
                        else torch.zeros(shape, dtype=bits.dtype,
                                         device=bits.device))
                bits = torch.cat([bits, fill], dim=1)
                m += pad
            s = bits.reshape(bits.shape[0], m // c, c,
                             bits.shape[2]).sum(dim=2)
            if op == "and":
                bits = self._wave(s, ("and_sum", c),
                                  lambda v, c=c: int(v == c))
            else:
                bits = self._wave(s, ("or_sum", c), lambda v: int(v != 0))
        return bits[:, 0]

    def _pair_eqs(self, blocks, pattern: str):
        """Pair-packed block equality of every (offset, pattern char):
        blocks [B, n, nb, sz] -> 0/1 bits [B, n_off, plen*npair, sz]."""
        msg = self.msg
        B, n, nb, sz = blocks.shape
        if nb % 2:
            raise ValueError("pair packing needs an even number of blocks")
        npair = nb // 2
        plen = len(pattern)
        n_off = n - plen + 1
        if n_off < 1:
            raise ValueError("the pattern is longer than the haystack")
        dev = blocks.device
        idx = np.arange(n_off)[:, None] + np.arange(plen)[None, :]
        g = blocks[:, _const(idx, dev)]             # [B, n_off, plen, nb, sz]
        packed = g[:, :, :, 1::2] * msg + g[:, :, :, 0::2]
        packed = packed.reshape(B, n_off, plen * npair, sz)
        # each slot's clear digit pair selects its eq LUT
        vals = []
        for c in pattern:
            digs = [(ord(c) // msg**d) % msg for d in range(nb)]
            vals.extend(digs[2 * p + 1] * msg + digs[2 * p]
                        for p in range(npair))
        luts = [self._lut(("pair_eq", v), lambda x, v=v: int(x == v))
                for v in range(msg * msg)]
        accs = torch.stack([lut.acc for lut in luts])
        sel = _const(np.tile(np.asarray(vals, np.int64), B * n_off), dev)
        out = self.sks._pbs_device(packed.reshape(-1, sz), accs[sel])
        return out.reshape(B, n_off, plen * npair, sz)

    def _offset_matches(self, blocks, pattern: str):
        """[B, n_off, sz] 0/1: the pattern matches at each offset."""
        bits = self._pair_eqs(blocks, pattern)         # [B, n_off, m, sz]
        B, n_off, m, sz = bits.shape
        match = self._sum_thresh(bits.reshape(B * n_off, m, sz), "and")
        return match.reshape(B, n_off, sz)

    def contains(self, blocks, pattern: str):
        """[B, n, nb, sz] -> [B, sz] 0/1 blocks (ref: contains.rs:18-41)."""
        return self._sum_thresh(self._offset_matches(blocks, pattern), "or")

    def find(self, blocks, pattern: str):
        """-> (found [B, sz], first-match indicator bits [B, n_off, sz]).

        The first match is isolated by a chunked prefix-OR (3 waves; see
        StringServerKey._prefix_or for the depth argument)."""
        msg = self.msg
        match = self._offset_matches(blocks, pattern)  # [B, n_off, sz]
        B, n_off, sz = match.shape
        dev = match.device
        cap = self.cap
        # in-chunk inclusive prefix sums (linear; noise <= cap)
        pad = (-n_off) % cap
        mp = torch.cat([match, torch.zeros((B, pad, sz), dtype=match.dtype,
                                           device=dev)], dim=1)
        nchunk = mp.shape[1] // cap
        s = torch.cumsum(mp.reshape(B, nchunk, cap, sz), dim=2).reshape(
            B, nchunk * cap, sz)[:, :n_off]
        pc = self._wave(s, ("or_sum", cap), lambda v: int(v != 0))
        if nchunk > 1:
            ends = np.minimum(np.arange(1, nchunk + 1) * cap - 1, n_off - 1)
            t = pc[:, _const(ends, dev)]
            # exclusive prefix sums of the <= cap chunk bools (linear)
            e = torch.cat([torch.zeros((B, 1, sz), dtype=t.dtype, device=dev),
                           torch.cumsum(t[:, :-1], dim=1)], dim=1)
            pb = self._wave(e, ("or_sum", cap), lambda v: int(v != 0))
            rep = np.repeat(np.arange(nchunk), cap)[:n_off]
            packed = pc * msg + pb[:, _const(rep, dev)]
            seen = self._wave(packed, "or_biv",
                              lambda v: int(bool(v // msg) or bool(v % msg)))
        else:
            seen = pc
        found = seen[:, -1]
        before = torch.cat([torch.zeros((B, 1, sz), dtype=seen.dtype,
                                        device=dev), seen[:, :-1]], dim=1)
        firsts = self._wave(
            match * msg + before, "first",
            lambda v: int(bool(v // msg) and not (v % msg)))
        return found, firsts


def encrypt_batch_strings(scks, texts, max_len: int) -> torch.Tensor:
    """B Python strings -> [B, max_len, nb, sz] block words (FINAL
    padding), on the client key's device."""
    key = scks.integer_key.key
    msg = key.params.message_modulus
    digs = []
    for t in texts:
        chars = [ord(c) for c in t] + [0] * (max_len - len(t))
        digs.extend((c // msg**d) % msg
                    for c in chars for d in range(NUMBER_BLOCKS))
    data = key.encrypt_batch(np.asarray(digs, np.uint64)).data
    return data.reshape(len(texts), max_len, NUMBER_BLOCKS, -1)
