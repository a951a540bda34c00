"""Layouts of ciphertext batches and server keys over a device mesh (port
of `tfhe_tpu/parallel/sharding.py`).

A ciphertext batch shards its leading (batch) axis over the mesh's
``batch`` axis: a `DTensor` whose placements are `Shard(0)` on that mesh
dimension and `Replicate()` on the others, the torch form of the
reference's PartitionSpec and of its rayon fan-out over independent PBS
(ref: integer/server_key/radix_parallel/add.rs:92-97).  Keys are
replicated: every rank holds the whole prepared key as local tensors,
since the kernels take plain tensors, not DTensors.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Placement, Replicate, Shard,
                                      distribute_tensor)

from ..ops.torus import to_tensor


def batch_spec(ndim: int, axis: str = "batch",
               mesh_dim_names: Sequence[str] = ("batch", "poly")
               ) -> Tuple[Placement, ...]:
    """Placements of an ndim-dimensional batch over a mesh with axes
    `mesh_dim_names`: its leading axis sharded over `axis`, replicated over
    the others (one placement per mesh axis, as DTensor takes them)."""
    if ndim < 1:
        raise ValueError("a batch has a leading axis to shard")
    if axis not in mesh_dim_names:
        raise ValueError(f"no mesh axis {axis!r} in {tuple(mesh_dim_names)}")
    return tuple(Shard(0) if name == axis else Replicate()
                 for name in mesh_dim_names)


def replicated(mesh: DeviceMesh) -> Tuple[Placement, ...]:
    return (Replicate(),) * mesh.ndim


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device in `mesh`."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def words_on(mesh: DeviceMesh, x) -> torch.Tensor:
    """Torus words (an int64 tensor, or uint64 / int64 numpy words) as an
    int64 tensor on this rank's device."""
    if isinstance(x, DTensor):
        raise TypeError("already a DTensor: pass the global words")
    if isinstance(x, torch.Tensor):
        if x.dtype != torch.int64:
            raise TypeError(f"torus words are int64 tensors, got {x.dtype}")
        return x.to(mesh_device(mesh))
    return to_tensor(np.asarray(x), mesh_device(mesh))


def shard_batch(mesh: DeviceMesh, x, axis: str = "batch") -> DTensor:
    """The global batch x sharded over `axis`.  Collective: every rank of
    the mesh calls it, and the words of the mesh's first rank are the
    ones distributed."""
    x = words_on(mesh, x)
    return distribute_tensor(
        x, mesh, batch_spec(x.ndim, axis, mesh.mesh_dim_names))


def _tensor_fields(key):
    return [f.name for f in dataclasses.fields(key)
            if isinstance(getattr(key, f.name), torch.Tensor)]


def key_shardings(mesh: DeviceMesh, bsk, ksk):
    """(bsk placements, ksk placements): for each tensor of a prepared key,
    by field name, its placements over the mesh.

    Keys are REPLICATED by design.  Batch data-parallelism needs no
    communication between devices on the hot path (each device bootstraps
    its own ciphertexts against a whole key), and the prepared 2_2 key is
    a few hundred MB, a small share of a card's memory.  The blind
    rotation contracts the key's spectrum axis inside the kernels, so a
    sharded key would need sharded kernels (key halves and a halo exchange
    of spectra), the scale-out path for keys that outgrow a device.
    Communication appears where it pays: the block-sharded carry scan
    (fused.py make_blockshard_radix_add) sends carry states between
    ranks."""
    rep = replicated(mesh)
    return ({name: rep for name in _tensor_fields(bsk)},
            {name: rep for name in _tensor_fields(ksk)})


def _replicate_key(mesh: DeviceMesh, key):
    """`key` with every tensor on this rank's device holding the words of
    the mesh's first rank: broadcast along each mesh axis in turn from its
    coordinate 0, so after the last axis every rank holds the first rank's
    words.  The caller's tensors are not written."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    dev = mesh_device(mesh)
    is_origin = not any(coord)
    out = {}
    for name in _tensor_fields(key):
        t = getattr(key, name).to(dev)
        # the first rank only sends; every other rank receives into a
        # buffer of its own
        t = t.contiguous() if is_origin else t.clone(
            memory_format=torch.contiguous_format)
        for dim in range(mesh.ndim):
            src = list(coord)
            src[dim] = 0
            dist.broadcast(t, src=int(mesh.mesh[tuple(src)]),
                           group=mesh.get_group(dim))
        out[name] = t
    return dataclasses.replace(key, **out)


def shard_server_key(mesh: DeviceMesh, bsk, ksk):
    """The prepared keys on every rank's device, replicated (see
    `key_shardings`): every tensor is broadcast from the mesh's first rank,
    so every rank holds its words, whether it generated, loaded or
    received its key.  Collective: every rank of the mesh calls it with
    keys of the same shapes."""
    return _replicate_key(mesh, bsk), _replicate_key(mesh, ksk)
