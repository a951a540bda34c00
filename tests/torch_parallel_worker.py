"""One rank of the port's multi-rank mesh tests (tests/test_torch_parallel_
ranks*.py), spawned once per rank by `spawn_world`: a gloo process group on
a FileStore (NCCL in tests/test_torch_parallel_cuda.py), the port's keys
from a seed, the mesh ops, and the results written as files for the parent
to hold against the reference.  Imports torch, numpy and tfhe_tpu_torch
only, never JAX or tfhe_tpu.

Rank r generates its keys from SEED + r, and ranks other than 0 hand
`place` zeros: every rank's result equals rank 0's words only if
`shard_server_key` broadcasts rank 0's key and `place` distributes rank
0's batch.
"""

import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from tfhe_tpu_torch import parallel, shortint
from tfhe_tpu_torch.parallel import fused as PF
from tfhe_tpu_torch.params import PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST as P

SEED = 8080


def _mesh(world, job, device):
    """The mesh a job runs on: the block-sharded add on a 1-D mesh of every
    rank; the batch-sharded ops on the default 2-D mesh at 4 ranks (batch
    2 x poly 2, shards replicated along poly), else on (world, 1)."""
    if job == "blockshard_add":
        return parallel.create_mesh((world,), ("batch",), device=device)
    if world == 4 and job in ("sharded_add", "sharded_mul"):
        return parallel.create_mesh(device=device)
    return parallel.create_mesh((world, 1), device=device)


def _run_job(job, world, sks, inputs):
    mesh = _mesh(world, job, sks.device.type)
    if job == "blockshard_add":
        nb = inputs["a"].shape[1]
        try:  # nb + 1 blocks do not divide over 2 or 4 ranks
            parallel.make_blockshard_radix_add(mesh, sks, nb + 1)
        except ValueError:
            pass
        else:
            raise AssertionError(f"{nb + 1} blocks over {world} ranks")
        step, place = parallel.make_blockshard_radix_add(mesh, sks, nb)
    elif job == "sharded_add":
        step, place = parallel.make_sharded_radix_add(
            mesh, sks, inputs["a"].shape[1])
    elif job == "sharded_mul":
        step, place = parallel.make_sharded_radix_mul(
            mesh, sks, inputs["a"].shape[1])
    elif job == "contains":
        step, place = parallel.make_sharded_strings_contains(
            mesh, sks, str(inputs["pattern"]))
    else:
        raise ValueError(job)
    names = ("chars",) if job == "contains" else ("a", "b")
    rank = dist.get_rank()
    args = [place(inputs[n] if rank == 0 else np.zeros_like(inputs[n]))
            for n in names]
    PF.reset_p2p_counts()
    out = step(*args)
    p2p = PF._shift_up_collective.p2p_ops
    return out.full_tensor(), list(out.to_local().shape), p2p


def _mesh_facts(world, device):
    """The default mesh's shape, this rank's coordinate in the mesh over
    the first rank alone, and whether a shape of another size is refused
    (every rank builds each mesh: it is collective)."""
    facts = {"default_shape": list(parallel.create_mesh(device=device).shape)}
    coord = parallel.local_mesh(1, device=device).get_coordinate()
    facts["local_mesh_1_coordinate"] = None if coord is None else list(coord)
    try:
        parallel.create_mesh((world + 1,), ("batch",), device=device)
    except ValueError:
        facts["wrong_size_refused"] = True
    return facts


def _write(workdir, name, record):
    with open(os.path.join(workdir, name), "w") as f:
        json.dump(record, f)


def run(rank, world, store, workdir, jobs, device):
    torch.set_num_threads(1)
    if device == "cuda":  # one card a rank, NCCL between them
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"file://{store}",
                            world_size=world, rank=rank)
    try:
        _, sks = shortint.gen_keys(P, seed=SEED + rank, device=device)
        _write(workdir, f"mesh_rank{rank}.json", _mesh_facts(world, device))
        for job in jobs:
            inputs = dict(np.load(os.path.join(workdir, f"{job}_in.npz")))
            words, local_shape, p2p = _run_job(job, world, sks, inputs)
            # every rank's gathered words, its shard's shape and the
            # point-to-point ops it issued
            np.save(os.path.join(workdir, f"{job}_out{rank}.npy"),
                    words.cpu().numpy().view(np.uint64))
            _write(workdir, f"{job}_rank{rank}.json",
                   {"p2p_ops": p2p, "local_shape": local_shape})
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn_world(world, workdir, jobs, device="cpu"):
    """Start `jobs` on `world` ranks, one spawned process each (gloo on the
    CPU; NCCL and card r for rank r with device="cuda"); the caller joins
    the returned context (`join` raises a failed rank's traceback)."""
    store = os.path.join(workdir, f"store_{world}")
    return mp.start_processes(run, args=(world, store, workdir, tuple(jobs),
                                         device),
                              nprocs=world, start_method="spawn", join=False)


def join_world(context, world, timeout_s=600):
    """Wait for a spawned world; kill its ranks if it outlives timeout_s."""
    deadline = time.monotonic() + timeout_s
    while not context.join(timeout=5):
        if time.monotonic() > deadline:
            for p in context.processes:
                p.kill()
            raise TimeoutError(f"{world} ranks still running")
