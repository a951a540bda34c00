"""Radix ops over a device mesh (port of the mesh half of
`tfhe_tpu/parallel/fused.py`, `:408-631`).

The single-program chains themselves (fused_ks_pbs, fused_radix_add,
fused_radix_mul, fused_strings_contains, ...) and their LUTs live in
`integer/fused.py` and are re-exported here.  This module binds them to a
mesh, each batch through `integer.fused.keyswitch_then_pbs` on the
replicated keys (`_pbs_on`):

- the batch-sharded steps (`make_sharded_radix_add`, `_mul`,
  `make_sharded_strings_contains`) run a chain on each rank's shard of the
  batch, with no communication in their body;
- the block-sharded add (`make_blockshard_radix_add`) spreads the BLOCK
  axis of each radix integer over the ranks: every round of its
  Hillis-Steele carry scan shifts carry states across rank boundaries
  with point-to-point sends (`_shift_up_collective`, the counterpart of
  the reference's `lax.ppermute`), while the PBS batches stay local.  It
  runs eagerly (NCCL's point-to-point calls are not captured into a CUDA
  graph).

Each `make_*` returns (step, place): `place(x)` distributes a global batch
(a collective: every rank calls it, and the mesh's first rank's words are
the source), `step(...)` takes and returns DTensors, running the chain on
the local shards (the kernels take plain tensors, never a DTensor);
`.full_tensor()` gathers a result.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Placement, Replicate, Shard,
                                      distribute_tensor)

from ..integer import fused as F
from ..integer.fused import (eq_chunk_widths, fused_ks_pbs,  # noqa: F401
                             fused_radix_add, fused_radix_bitop,
                             fused_radix_cmp, fused_radix_eq,
                             fused_radix_minmax, fused_radix_mul,
                             fused_radix_neg, fused_radix_select,
                             fused_radix_sub, fused_radix_univariate,
                             fused_strings_contains)
from .sharding import batch_spec, mesh_device, shard_server_key, words_on


def _permute_up(x: torch.Tensor, k: int, ranks: Sequence[int], me: int,
                group) -> torch.Tensor:
    """The non-cyclic permutation [(i, i + k)] over the group's ranks: this
    rank's x goes to the rank k above, and x of the rank k below comes in;
    the bottom k ranks receive zeros, and nothing is sent to them."""
    out = torch.zeros_like(x)
    ops = []
    if me + k < len(ranks):
        ops.append(dist.P2POp(dist.isend, x, ranks[me + k], group))
    if me >= k:
        ops.append(dist.P2POp(dist.irecv, out, ranks[me - k], group))
    _shift_up_collective.p2p_ops += len(ops)
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out


def _shift_up_collective(x: torch.Tensor, d: int, group) -> torch.Tensor:
    """Global block shift towards higher significance for BLOCK-SHARDED
    radix state: x [B, nbl, sz] is this rank's contiguous slice of the
    global [B, nb, sz] block axis (the i-th rank of `group` holds blocks
    [i*nbl, (i+1)*nbl)).  out_global[j] = in_global[j - d], zeros shifted
    in at the bottom.

    A whole-shard move by k = d // nbl ranks, then a halo of r = d % nbl
    blocks from the rank below, each one batch of point-to-point ops; when
    k >= the group's size every block shifts out and the result is zeros.
    `_shift_up_collective.p2p_ops` counts the sends and receives this
    process issued."""
    ranks = dist.get_process_group_ranks(group)
    me = ranks.index(dist.get_rank())
    nbl = x.shape[1]
    k, r = divmod(d, nbl)
    x = x.contiguous()
    if k:
        if k >= len(ranks):
            return torch.zeros_like(x)
        x = _permute_up(x, k, ranks, me, group)
    if r:
        recv = _permute_up(x[:, nbl - r:].contiguous(), 1, ranks, me, group)
        x = torch.cat([recv, x[:, :nbl - r]], dim=1)
    return x


_shift_up_collective.p2p_ops = 0


def reset_p2p_counts() -> None:
    _shift_up_collective.p2p_ops = 0


def fused_radix_add_blockshard(pbs, state_acc, resolve_acc, carry_acc,
                               msgext_acc, a, b, *, message_modulus: int,
                               num_blocks: int, ndev: int, axis):
    """Radix add with the BLOCK axis sharded over the ranks of `axis` (the
    mesh axis's process group): the collective Hillis-Steele carry scan,
    every scan round's block shift crossing rank boundaries while the PBS
    batches (`pbs(rows, acc)`, as the chains') stay local.  a, b are this
    rank's shards [B, nb/ndev, sz] (ref: radix_parallel/add.rs:518-603,
    here spanning devices for radix widths past one device's batch
    budget)."""
    if dist.get_world_size(axis) != ndev:
        raise ValueError(f"the axis holds {dist.get_world_size(axis)} "
                         f"ranks, not {ndev}")
    s = a + b
    state = F._batch(pbs, state_acc, s)
    d = 1
    while d < num_blocks:
        prev = _shift_up_collective(state, d, axis)
        state = F._batch(pbs, resolve_acc, state * message_modulus + prev)
        d *= 2
    carries = F._batch(pbs, carry_acc, state)
    carry_in = _shift_up_collective(carries, 1, axis)
    return F._batch(pbs, msgext_acc, s + carry_in)


def _global_shape(local: torch.Tensor, like: DTensor, placements):
    shape = list(local.shape)
    for p in placements:
        if isinstance(p, Shard):
            shape[p.dim] = like.shape[p.dim]
    stride = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        stride[i] = stride[i + 1] * shape[i + 1]
    return torch.Size(shape), tuple(stride)


def bind_to_mesh(mesh: DeviceMesh, placements: Sequence[Placement], fn):
    """(step, place) for a chain `fn` of local tensors, its inputs and its
    output laid out by `placements` on `mesh` (the output's sharded axes
    as long as the first input's).  A step checks that every input is a
    DTensor laid out so, runs `fn` on the local shards and wraps the local
    result; place(x) distributes a global batch from the mesh's first
    rank.  The make_* functions below are bound through it; so is a
    batch-sharded keyswitch + PBS: `bind_to_mesh(mesh, batch_spec(2),
    functools.partial(fused_ks_pbs, ksk, bsk, acc))`."""
    placements = tuple(placements)

    def step(*args):
        for x in args:
            if not isinstance(x, DTensor):
                raise TypeError("a mesh step takes DTensors (from place)")
            if x.device_mesh != mesh or tuple(x.placements) != placements:
                raise ValueError(f"input laid out as {x.placements} on "
                                 f"{x.device_mesh}, the step takes "
                                 f"{placements} on {mesh}")
        out = fn(*(x.to_local() for x in args))
        shape, stride = _global_shape(out, args[0], placements)
        return DTensor.from_local(out, mesh, placements, shape=shape,
                                  stride=stride)

    def place(x):
        return distribute_tensor(words_on(mesh, x), mesh, placements)

    # the chain on local tensors: a batch-sharded step's is the unsharded
    # op, which runs a whole batch
    step.chain = fn
    return step, place


def make_blockshard_radix_add(mesh: DeviceMesh, sks, num_blocks: int,
                              axis: str = "batch"):
    """Bind a shortint ServerKey and a mesh into a radix add whose BLOCK
    axis spans the mesh axis `axis` (keys replicated, carry states sent
    between ranks).

    Returns (step, place): step(a, b) -> clean sum, a and b [B, nb, sz]
    DTensors with the blocks `Shard(1)` over `axis` (replicated over any
    other axis)."""
    ndev = mesh.size(mesh.mesh_dim_names.index(axis))
    if num_blocks % ndev:
        raise ValueError(f"num_blocks {num_blocks} not divisible by "
                         f"mesh axis {axis}={ndev}")
    accs = F._accs(sks, F._CARRY_LUTS, device=mesh_device(mesh))
    bsk, ksk = shard_server_key(mesh, sks.bsk, sks.ksk)
    placements = tuple(Shard(1) if name == axis else Replicate()
                       for name in mesh.mesh_dim_names)
    body = functools.partial(
        fused_radix_add_blockshard, F._pbs_on(ksk, bsk, sks.mode), *accs,
        message_modulus=sks.message_modulus, num_blocks=num_blocks,
        ndev=ndev, axis=mesh.get_group(axis))
    return bind_to_mesh(mesh, placements, body)


def make_sharded_radix_add(mesh: DeviceMesh, sks, num_blocks: int):
    """Bind a shortint ServerKey and a mesh into a batch-sharded radix add.

    Returns (step, place): step(a, b) -> clean sum, with a and b [B, nb,
    lwe_size] DTensors sharded on the mesh's ``batch`` axis; place(x) puts
    a global batch onto the mesh.  `num_blocks` is the radix width, as the
    reference's signature has it; the chain reads it from the blocks."""
    bsk, ksk = shard_server_key(mesh, sks.bsk, sks.ksk)
    body = F._radix_op(sks, "add", num_blocks,
                       F._pbs_on(ksk, bsk, sks.mode), device=mesh_device(mesh))
    return bind_to_mesh(mesh, batch_spec(3, "batch",
                                         mesh.mesh_dim_names), body)


def make_sharded_radix_mul(mesh: DeviceMesh, sks, num_blocks: int):
    """Bind a shortint ServerKey and a mesh into a batch-sharded radix mul
    (the contract of make_sharded_radix_add)."""
    bsk, ksk = shard_server_key(mesh, sks.bsk, sks.ksk)
    body = F._radix_op(sks, "mul", num_blocks,
                       F._pbs_on(ksk, bsk, sks.mode), device=mesh_device(mesh))
    return bind_to_mesh(mesh, batch_spec(3, "batch",
                                         mesh.mesh_dim_names), body)


def make_sharded_strings_contains(mesh: DeviceMesh, sks, pattern: str):
    """Bind a shortint ServerKey, a mesh and a clear pattern into a
    batch-sharded contains over [B, n, nb, sz] char batches; the result is
    [B, sz] 0/1 blocks, sharded alike."""
    from ..strings.client_key import NUMBER_BLOCKS

    msg = sks.message_modulus
    nb = NUMBER_BLOCKS
    pat_digits = tuple(
        tuple((ord(c) // msg**d) % msg for d in range(nb)) for c in pattern)
    accs = F._accs(sks, F._CONTAINS_LUTS, device=mesh_device(mesh))
    bsk, ksk = shard_server_key(mesh, sks.bsk, sks.ksk)
    body = functools.partial(fused_strings_contains,
                             F._pbs_on(ksk, bsk, sks.mode), *accs,
                             pat_digits=pat_digits, message_modulus=msg,
                             delta=sks.delta)
    return bind_to_mesh(mesh, batch_spec(4, "batch",
                                         mesh.mesh_dim_names), body)
