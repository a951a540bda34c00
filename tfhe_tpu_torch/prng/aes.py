"""Vectorized AES-128 (ECB over counter blocks) — the CSPRNG block cipher.

Copy of `tfhe_tpu/prng/aes.py` with the port's own native build.  Two backends:

  * "native": the C++ generator in `csrc/aes_csprng.cpp` (AES-NI when the CPU
    has it), built by g++ at first use into the package's `_build/` directory
    and loaded with ctypes;
  * "numpy": a table-based implementation vectorized over a batch of counter
    blocks, the plain version of the native one.

`Aes128` uses the native backend unless the caller asks for numpy, and a
failed native build raises `BuildError`: the backend in use is always the one
asked for, and `Aes128.backend` names it.

Counters are encrypted as their little-endian 16-byte encoding, matching the
reference's `u128_to_si128(aes_ctr)` transmute on x86
(ref: concrete-csprng/src/generators/implem/aesni/block_cipher.rs:33-48).
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from .._native import build_shared_library

# ---------------------------------------------------------------------------
# AES tables
# ---------------------------------------------------------------------------

_SBOX = np.array([
    0x63, 0x7c, 0x77, 0x7b, 0xf2, 0x6b, 0x6f, 0xc5, 0x30, 0x01, 0x67, 0x2b,
    0xfe, 0xd7, 0xab, 0x76, 0xca, 0x82, 0xc9, 0x7d, 0xfa, 0x59, 0x47, 0xf0,
    0xad, 0xd4, 0xa2, 0xaf, 0x9c, 0xa4, 0x72, 0xc0, 0xb7, 0xfd, 0x93, 0x26,
    0x36, 0x3f, 0xf7, 0xcc, 0x34, 0xa5, 0xe5, 0xf1, 0x71, 0xd8, 0x31, 0x15,
    0x04, 0xc7, 0x23, 0xc3, 0x18, 0x96, 0x05, 0x9a, 0x07, 0x12, 0x80, 0xe2,
    0xeb, 0x27, 0xb2, 0x75, 0x09, 0x83, 0x2c, 0x1a, 0x1b, 0x6e, 0x5a, 0xa0,
    0x52, 0x3b, 0xd6, 0xb3, 0x29, 0xe3, 0x2f, 0x84, 0x53, 0xd1, 0x00, 0xed,
    0x20, 0xfc, 0xb1, 0x5b, 0x6a, 0xcb, 0xbe, 0x39, 0x4a, 0x4c, 0x58, 0xcf,
    0xd0, 0xef, 0xaa, 0xfb, 0x43, 0x4d, 0x33, 0x85, 0x45, 0xf9, 0x02, 0x7f,
    0x50, 0x3c, 0x9f, 0xa8, 0x51, 0xa3, 0x40, 0x8f, 0x92, 0x9d, 0x38, 0xf5,
    0xbc, 0xb6, 0xda, 0x21, 0x10, 0xff, 0xf3, 0xd2, 0xcd, 0x0c, 0x13, 0xec,
    0x5f, 0x97, 0x44, 0x17, 0xc4, 0xa7, 0x7e, 0x3d, 0x64, 0x5d, 0x19, 0x73,
    0x60, 0x81, 0x4f, 0xdc, 0x22, 0x2a, 0x90, 0x88, 0x46, 0xee, 0xb8, 0x14,
    0xde, 0x5e, 0x0b, 0xdb, 0xe0, 0x32, 0x3a, 0x0a, 0x49, 0x06, 0x24, 0x5c,
    0xc2, 0xd3, 0xac, 0x62, 0x91, 0x95, 0xe4, 0x79, 0xe7, 0xc8, 0x37, 0x6d,
    0x8d, 0xd5, 0x4e, 0xa9, 0x6c, 0x56, 0xf4, 0xea, 0x65, 0x7a, 0xae, 0x08,
    0xba, 0x78, 0x25, 0x2e, 0x1c, 0xa6, 0xb4, 0xc6, 0xe8, 0xdd, 0x74, 0x1f,
    0x4b, 0xbd, 0x8b, 0x8a, 0x70, 0x3e, 0xb5, 0x66, 0x48, 0x03, 0xf6, 0x0e,
    0x61, 0x35, 0x57, 0xb9, 0x86, 0xc1, 0x1d, 0x9e, 0xe1, 0xf8, 0x98, 0x11,
    0x69, 0xd9, 0x8e, 0x94, 0x9b, 0x1e, 0x87, 0xe9, 0xce, 0x55, 0x28, 0xdf,
    0x8c, 0xa1, 0x89, 0x0d, 0xbf, 0xe6, 0x42, 0x68, 0x41, 0x99, 0x2d, 0x0f,
    0xb0, 0x54, 0xbb, 0x16,
], dtype=np.uint8)

_RCON = np.array([0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36],
                 dtype=np.uint8)

# xtime (multiplication by 2 in GF(2^8)) as a table for vectorization
_XTIME = np.empty(256, dtype=np.uint8)
for _i in range(256):
    _v = _i << 1
    if _i & 0x80:
        _v ^= 0x11B
    _XTIME[_i] = _v & 0xFF

# ShiftRows permutation on the 16-byte block laid out column-major
# (byte i -> state[row=i%4][col=i//4]; ShiftRows rotates row r left by r).
_SHIFT_ROWS = np.array(
    [0, 5, 10, 15, 4, 9, 14, 3, 8, 13, 2, 7, 12, 1, 6, 11], dtype=np.intp
)


def key_expansion(key_bytes: bytes | np.ndarray) -> np.ndarray:
    """AES-128 key schedule: 16-byte key -> [11, 16] round keys."""
    key = np.frombuffer(bytes(key_bytes), dtype=np.uint8).copy()
    assert key.size == 16
    words = [key[0:4], key[4:8], key[8:12], key[12:16]]
    for i in range(4, 44):
        temp = words[i - 1].copy()
        if i % 4 == 0:
            temp = np.roll(temp, -1)
            temp = _SBOX[temp]
            temp[0] ^= _RCON[i // 4 - 1]
        words.append(words[i - 4] ^ temp)
    return np.concatenate(words).reshape(11, 16)


def _mix_columns(state: np.ndarray) -> np.ndarray:
    """MixColumns on [n, 16] states (column-major byte layout)."""
    s = state.reshape(-1, 4, 4)  # [n, col, row]
    a0, a1, a2, a3 = s[:, :, 0], s[:, :, 1], s[:, :, 2], s[:, :, 3]
    t = a0 ^ a1 ^ a2 ^ a3
    out = np.empty_like(s)
    out[:, :, 0] = a0 ^ t ^ _XTIME[a0 ^ a1]
    out[:, :, 1] = a1 ^ t ^ _XTIME[a1 ^ a2]
    out[:, :, 2] = a2 ^ t ^ _XTIME[a2 ^ a3]
    out[:, :, 3] = a3 ^ t ^ _XTIME[a3 ^ a0]
    return out.reshape(-1, 16)


def encrypt_blocks_numpy(round_keys: np.ndarray, blocks: np.ndarray) -> np.ndarray:
    """Encrypt [n, 16] uint8 blocks with AES-128. Vectorized over n."""
    state = blocks ^ round_keys[0]
    for rnd in range(1, 10):
        state = _SBOX[state]
        state = state[:, _SHIFT_ROWS]
        state = _mix_columns(state)
        state ^= round_keys[rnd]
    state = _SBOX[state]
    state = state[:, _SHIFT_ROWS]
    state ^= round_keys[10]
    return state


def counters_to_blocks(start: int, count: int) -> np.ndarray:
    """[count, 16] little-endian byte encodings of start..start+count (mod 2^128)."""
    out = np.empty((count, 16), dtype=np.uint8)
    start %= 1 << 128
    # Vectorize in two u64 halves to avoid per-element python ints for big counts
    base_lo = start & 0xFFFFFFFFFFFFFFFF
    base_hi = start >> 64
    with np.errstate(over="ignore"):
        offs = np.arange(count, dtype=np.uint64)
        lo = np.uint64(base_lo) + offs  # wraps mod 2^64
        carries = lo < np.uint64(base_lo)
        hi = np.uint64(base_hi) + carries.astype(np.uint64)
    out[:, 0:8] = lo[:, None].view(np.uint8).reshape(count, 8)
    out[:, 8:16] = hi[:, None].view(np.uint8).reshape(count, 8)
    return out


# ---------------------------------------------------------------------------
# Native backend (ctypes)
# ---------------------------------------------------------------------------

BACKENDS = ("native", "numpy")
_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                       "aes_csprng.cpp")


@functools.cache
def native_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the native AES-CTR library.

    Raises `tfhe_tpu_torch._native.BuildError` with g++'s stderr on failure."""
    path = build_shared_library(
        "aes_csprng", [_SOURCE], ["g++", "-O3", "-shared", "-fPIC"],
        timeout=120)
    lib = ctypes.CDLL(path)
    lib.aes128_ctr_blocks.argtypes = [
        ctypes.c_char_p,                   # 16-byte key
        ctypes.c_uint64, ctypes.c_uint64,  # start counter lo, hi
        ctypes.c_size_t,                   # n blocks
        ctypes.c_char_p,                   # out buffer n*16
    ]
    lib.aes128_ctr_blocks.restype = None
    return lib


class Aes128:
    """AES-128 block encryptor over counter ranges."""

    def __init__(self, key_u128: int, backend: str = "native"):
        if backend not in BACKENDS:
            raise ValueError(f"unknown AES backend {backend!r}")
        self.key_u128 = key_u128 % (1 << 128)
        self.key_bytes = self.key_u128.to_bytes(16, "little")
        self.backend = backend
        self._round_keys = key_expansion(self.key_bytes)
        self._native = native_library() if backend == "native" else None

    def ctr_blocks(self, start_counter: int, count: int) -> np.ndarray:
        """Encrypt counters start..start+count-1 -> [count*16] uint8 stream."""
        if count == 0:
            return np.empty(0, dtype=np.uint8)
        start_counter %= 1 << 128
        if self._native is not None:
            out = np.empty(count * 16, dtype=np.uint8)
            self._native.aes128_ctr_blocks(
                self.key_bytes,
                ctypes.c_uint64(start_counter & 0xFFFFFFFFFFFFFFFF),
                ctypes.c_uint64(start_counter >> 64),
                count,
                out.ctypes.data_as(ctypes.c_char_p),
            )
            return out
        blocks = counters_to_blocks(start_counter, count)
        return encrypt_blocks_numpy(self._round_keys, blocks).reshape(-1)
