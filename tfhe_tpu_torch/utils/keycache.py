"""Persistent, file-locked key cache keyed by parameter-set name.

Port of `tfhe_tpu/utils/keycache.py` (ref: tfhe/src/keycache/mod.rs:58-228
FileStorage/KeyCache with file locks + an in-memory cache;
shortint/keycache.rs named_params_impl!): tests and benches fetch keys by
named parameter set instead of regenerating bootstrap keys.  Entries are
the wire format of `utils.serialization`, so both packages share them; a
hit rebuilds the key on the caller's device.
"""

from __future__ import annotations

import fcntl
import os
from typing import Any, Callable, Dict, Optional, Tuple

from .serialization import safe_deserialize, safe_serialize


class KeyCache:
    """Two tiers: an in-memory dict and on-disk serialized blobs guarded by
    advisory file locks (safe under concurrent test runners)."""

    def __init__(self, directory: str = ".keycache"):
        self.directory = directory
        self._mem: Dict[str, Any] = {}

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, f"{name}.tfhekeys")

    def get(self, name: str, factory: Callable[[], Any],
            device="cuda") -> Any:
        """Fetch `name`, generating and persisting it on a miss; a hit on
        disk is deserialized onto `device`.  The factory's value must
        round-trip through utils.serialization."""
        key = (name, str(device))
        if key in self._mem:
            return self._mem[key]
        os.makedirs(self.directory, exist_ok=True)
        path = self._path(name)
        with open(path + ".lock", "w") as lock_f:
            fcntl.flock(lock_f, fcntl.LOCK_EX)
            try:
                if os.path.exists(path):
                    with open(path, "rb") as f:
                        obj = safe_deserialize(f.read(), device=device)
                else:
                    obj = factory()
                    tmp = path + ".tmp"
                    with open(tmp, "wb") as f:
                        f.write(safe_serialize(obj))
                    os.replace(tmp, path)
            finally:
                fcntl.flock(lock_f, fcntl.LOCK_UN)
        self._mem[key] = obj
        return obj

    def get_shortint_keys(self, params, seed: Optional[int] = None,
                          device="cuda") -> Tuple[Any, Any]:
        """(ClientKey, ServerKey) of a named shortint parameter set on
        `device` (ref: shortint/keycache.rs KEY_CACHE.get_from_param)."""
        from ..shortint import ClientKey, ServerKey

        tag = f"{params.name}_s{seed}" if seed is not None else params.name
        cks = self.get(f"{tag}_client",
                       lambda: ClientKey(params, seed=seed, device=device),
                       device=device)
        sks = self.get(f"{tag}_server", lambda: ServerKey(cks),
                       device=device)
        return cks, sks

    def clear_memory(self) -> None:
        self._mem.clear()


#: Process-wide default cache (ref: keycache KEY_CACHE statics)
KEY_CACHE = KeyCache()
