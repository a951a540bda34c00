"""Forkable AES-CTR byte stream.

Copy of `tfhe_tpu/prng/stream.py`; equivalent of `AesCtrGenerator` + `TableIndex`
(ref: concrete-csprng/src/generators/aes_ctr/{generic.rs,index.rs}).

The pseudorandom table is the byte sequence
    table[i] = AES_k(counter = i // 16)[i % 16]
A stream is a window [current, bound) over that table; `try_fork` partitions
the front of the window into `n_children` contiguous sub-windows of
`bytes_per_child` bytes each and advances the parent past them — the same
tree-forking semantics that make the reference's parallel keygen bit-identical
to its sequential keygen (ref: aes_ctr/parallel.rs, generic.rs try_fork).
A stream and its forks share one `Aes128`, whose `backend` the stream reports.

Fresh root streams start at absolute byte index 1 (TableIndex::SECOND,
ref: aes_ctr/index.rs:27-31 and generic.rs:43-56).
"""

from __future__ import annotations

import numpy as np

from .aes import Aes128

_TABLE_BYTES = 1 << 132  # 2^128 blocks * 16 bytes

class ForkError(Exception):
    pass


class AesCtrStream:
    """A bounded, forkable window over the AES-CTR pseudorandom byte table."""

    def __init__(self, key: int, start: int = 1, bound: int = _TABLE_BYTES,
                 backend: str = "native"):
        self._aes = Aes128(key, backend=backend)
        self.key = self._aes.key_u128
        self.current = start          # absolute byte index of next output byte
        self.bound = bound            # first absolute byte index NOT ours

    @property
    def backend(self) -> str:
        """The AES backend this stream draws from ("native" or "numpy")."""
        return self._aes.backend

    # -- byte output --------------------------------------------------------

    def remaining_bytes(self) -> int:
        return self.bound - self.current

    def next_bytes(self, n: int) -> np.ndarray:
        """The next n bytes of the stream as a uint8 array."""
        if n < 0 or self.current + n > self.bound:
            raise ForkError(
                f"stream exhausted: asked {n}, have {self.remaining_bytes()}"
            )
        if n == 0:
            return np.empty(0, dtype=np.uint8)
        first_block = self.current // 16
        last_block = (self.current + n - 1) // 16
        raw = self._aes.ctr_blocks(first_block, last_block - first_block + 1)
        off = self.current % 16
        self.current += n
        return raw[off:off + n]

    def next_byte(self) -> int:
        return int(self.next_bytes(1)[0])

    # -- forking ------------------------------------------------------------

    def try_fork(self, n_children: int, bytes_per_child: int) -> list["AesCtrStream"]:
        """Partition the front of this stream into n_children sub-streams.

        Child i owns bytes [current + i*b, current + (i+1)*b); the parent
        advances past all of them.
        """
        total = n_children * bytes_per_child
        if self.current + total > self.bound:
            raise ForkError(
                f"cannot fork: need {total} bytes, have {self.remaining_bytes()}"
            )
        children = []
        for i in range(n_children):
            child = AesCtrStream.__new__(AesCtrStream)
            child._aes = self._aes
            child.key = self.key
            child.current = self.current + i * bytes_per_child
            child.bound = child.current + bytes_per_child
            children.append(child)
        self.current += total
        return children


class Seeder:
    """Deterministic seeder: expands one root seed into a sequence of seeds.

    Mirrors `DeterministicSeeder` (ref: concrete-csprng/src/seeders/ +
    tfhe/src/core_crypto/commons/generators/seeder.rs:58): an internal CSPRNG
    whose output bytes become the 128-bit seeds handed to each generator.
    """

    def __init__(self, root_seed: int):
        self._stream = AesCtrStream(root_seed)

    def seed(self) -> int:
        return int.from_bytes(bytes(self._stream.next_bytes(16)), "little")


def system_seeder() -> Seeder:
    """Seeder rooted in OS entropy (equivalent of the unix /dev/random seeder,
    ref: concrete-csprng/src/seeders/implem/unix.rs)."""
    import secrets

    return Seeder(secrets.randbits(128))
