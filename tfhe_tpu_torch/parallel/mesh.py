"""Process groups and device meshes (port of `tfhe_tpu/parallel/mesh.py`).

The reference runs one controller over every device of a slice (ICI
within it, DCN across slices).  The port runs torch's idiom: one process
per device under `torch.distributed`, each process a rank of one process
group, and a `DeviceMesh` naming the ranks' axes (``batch`` x ``poly``).
A card's ranks talk over NCCL, CPU ranks over gloo; a mesh on a card never
runs on gloo (gloo has no send or receive for CUDA tensors).  The world,
the rank and the backend are arguments: no environment variable chooses
them.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..device import resolve_device


def _backend(dev: torch.device) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device="cuda") -> None:
    """Join this process to a world of `num_processes` ranks as rank
    `process_id`, rendezvous at tcp://`coordinator_address` (host:port);
    a no-op for one process.  On a card the backend is NCCL and the process
    takes card `process_id % torch.cuda.device_count()` (ranks numbered
    host by host); on the CPU (device="cpu") it is gloo."""
    dev = resolve_device(device)
    if num_processes is None or num_processes <= 1:
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("a world of several processes needs the "
                         "coordinator's address and this process's id")
    if dev.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        _backend(dev), init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)


def _group_for(dev: torch.device) -> None:
    """The process group a mesh on `dev` runs on: the one this process has
    joined, or, with none, a group of this process alone on a private
    store (the counterpart of a single-process JAX mesh)."""
    want = _backend(dev)
    if not dist.is_initialized():
        dist.init_process_group(want, store=dist.HashStore(), rank=0,
                                world_size=1)
        return
    have = dist.get_backend()
    if want not in have:
        raise RuntimeError(f"a mesh on {dev.type} runs on {want}; this "
                           f"process group's backend is {have}")


def create_mesh(shape: Optional[Tuple[int, ...]] = None,
                axis_names: Sequence[str] = ("batch", "poly"),
                device="cuda", ranks: Optional[Sequence[int]] = None
                ) -> DeviceMesh:
    """Mesh over `ranks` (default: every rank of the world), one device a
    rank.  With the default 2-D axes the ``poly`` extent is the largest
    power of two <= 2 that divides the rank count, unless a shape is given.
    Building a mesh is collective: every rank of the world calls it."""
    dev = resolve_device(device)
    _group_for(dev)
    if ranks is None:
        ranks = range(dist.get_world_size())
    ranks = np.asarray(list(ranks), dtype=np.int64)
    n = ranks.size
    if shape is None:
        if len(axis_names) == 1:
            shape = (n,)
        else:
            poly = 2 if n % 2 == 0 and n > 1 else 1
            shape = (n // poly, poly) + (1,) * (len(axis_names) - 2)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != device count {n}")
    return DeviceMesh(dev.type, torch.from_numpy(ranks.reshape(shape)),
                      mesh_dim_names=tuple(axis_names))


def local_mesh(n: Optional[int] = None,
               axis_names: Sequence[str] = ("batch", "poly"),
               device="cuda") -> DeviceMesh:
    """Mesh over the first n ranks of the world (default: all), one device
    a rank.  Every rank of the world calls it; a rank past the first n gets
    the mesh with no coordinate in it (`get_coordinate()` is None) and takes
    no part in its ops."""
    return create_mesh(axis_names=axis_names, device=device,
                       ranks=None if n is None else range(n))
