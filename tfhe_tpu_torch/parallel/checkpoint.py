"""Checkpoint/resume and failure handling for long-running FHE jobs (port
of `tfhe_tpu/parallel/checkpoint.py`).

The reference has no distributed runtime, so its nearest analogue is
serde-serializable keys + the keycache (ref: tfhe/src/keycache/mod.rs,
entities/seeded_* compression).  A job that bootstraps millions of
ciphertexts over many devices needs more: it must survive a lost device or
a restarted host.  This subsystem provides:

- CheckpointManager: atomic on-disk snapshots of any serializable objects
  (keys, ciphertext batches) with monotonically numbered steps and
  last-good discovery, the "checkpoint reload" half of recovery;
- ResumableBatchRunner: chunked execution of a batched FHE function with
  a checkpoint after every chunk, automatic retry with exponential
  backoff on device failure, and exact resume (completed chunks are never
  recomputed, so results are bit-identical to an uninterrupted run, which
  the exact NTT arithmetic guarantees).

The layout is the reference's (`<host_tag>_step%08d/{name}.bin` and
`manifest.json`), and the `.bin` files are the wire format's bytes
(`utils.serialization`), which equal the reference's: each package reads
the other's checkpoints.  Several ranks: every rank runs the same chunk
schedule over its own shard; `host_tag` keeps each rank's checkpoints
apart, so a restarted rank reloads only its own.
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..device import resolve_device
from ..utils.serialization import safe_deserialize, safe_serialize


class CheckpointManager:
    """Checkpoints under `directory`; `load` puts their tensors on `device`
    unless given another."""

    def __init__(self, directory: str, host_tag: str = "host0",
                 device="cuda"):
        self.directory = directory
        self.host_tag = host_tag
        self.device = resolve_device(device)
        os.makedirs(directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"{self.host_tag}_step{step:08d}")

    def save(self, step: int, objects: Dict[str, Any]) -> None:
        """Atomic: writes into a temp dir, then renames (a crash mid-save
        leaves no half-visible checkpoint)."""
        final = self._step_dir(step)
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "keys": sorted(objects), "ts": time.time()}
        for name, obj in objects.items():
            with open(os.path.join(tmp, f"{name}.bin"), "wb") as f:
                f.write(safe_serialize(obj))
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            # never overwrite a completed checkpoint
            for fn in os.listdir(tmp):
                os.remove(os.path.join(tmp, fn))
            os.rmdir(tmp)
            return
        os.rename(tmp, final)

    def latest_step(self) -> Optional[int]:
        pat = re.compile(rf"{re.escape(self.host_tag)}_step(\d+)$")
        steps = []
        for name in os.listdir(self.directory):
            m = pat.match(name)
            if m and os.path.exists(os.path.join(self.directory, name,
                                                 "manifest.json")):
                steps.append(int(m.group(1)))
        return max(steps) if steps else None

    def load(self, step: int, device=None) -> Dict[str, Any]:
        d = self._step_dir(step)
        device = self.device if device is None else resolve_device(device)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        out = {}
        for name in manifest["keys"]:
            with open(os.path.join(d, f"{name}.bin"), "rb") as f:
                out[name] = safe_deserialize(f.read(), device=device)
        return out

    def load_latest(self) -> Tuple[Optional[int], Dict[str, Any]]:
        step = self.latest_step()
        if step is None:
            return None, {}
        return step, self.load(step)


class DeviceFailure(RuntimeError):
    pass


def default_health_check(device: torch.device) -> None:
    """Probe the device the data lives on; raises on a lost card (the
    restart hook point for re-joining the process group)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise DeviceFailure("no CUDA device visible")
    probe = torch.zeros(1, device=device) + 1
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if probe.item() != 1:
        raise DeviceFailure(f"{device} computed 0 + 1 = {probe.item()}")


class ResumableBatchRunner:
    """Run `fn(chunk_tensor) -> result_tensor` over a large batch in chunks,
    checkpointing each completed chunk and resuming exactly after failures.
    """

    def __init__(self, ckpt: CheckpointManager, chunk_size: int,
                 max_retries: int = 3, backoff_s: float = 0.1,
                 health_check: Callable[[torch.device], None]
                 = default_health_check):
        self.ckpt = ckpt
        self.chunk_size = chunk_size
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.health_check = health_check

    def run(self, fn: Callable[[torch.Tensor], Any], data: torch.Tensor,
            wrap: Callable[[torch.Tensor], Any],
            unwrap: Callable[[Any], torch.Tensor]) -> torch.Tensor:
        """`wrap`/`unwrap` convert chunk results to/from a serializable
        object (e.g. a ShortintBatch).  Chunks, results and the chunks
        loaded from checkpoints stay on `data`'s device."""
        n = data.shape[0]
        n_chunks = -(-n // self.chunk_size)
        start_step = self.ckpt.latest_step()
        done = (start_step + 1) if start_step is not None else 0
        results: List[torch.Tensor] = [
            unwrap(self.ckpt.load(i, data.device)["chunk"])
            for i in range(done)
        ]
        for i in range(done, n_chunks):
            lo, hi = i * self.chunk_size, min((i + 1) * self.chunk_size, n)
            chunk = data[lo:hi]
            attempt = 0
            while True:
                try:
                    self.health_check(data.device)
                    out = torch.as_tensor(fn(chunk), device=data.device)
                    break
                except Exception:
                    attempt += 1
                    if attempt > self.max_retries:
                        raise
                    time.sleep(self.backoff_s * (2 ** (attempt - 1)))
            self.ckpt.save(i, {"chunk": wrap(out)})
            results.append(out)
        return torch.cat(results, dim=0)
