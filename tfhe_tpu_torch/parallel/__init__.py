"""Device-mesh scaling: the subsystem the reference does not have (port of
`tfhe_tpu/parallel`).

The reference's parallelism is single-node rayon (SURVEY.md component
#27/#28).  Here ciphertext batches are sharded over a
`torch.distributed.device_mesh.DeviceMesh`, one process per device under
`torch.distributed` (NCCL between cards, gloo between CPU ranks), and the
communication is explicit.  Axes:

- ``batch``: data parallelism over independent ciphertexts (the
  reference's rayon par_iter over blocks/PBS, ref:
  integer/server_key/radix_parallel/); a batch is a DTensor sharded on
  it, each rank bootstrapping its shard with no communication;
- ``poly``: kept for the reference's mesh shape; keys are replicated over
  every axis (sharding.key_shardings says why), so ranks along ``poly``
  hold the same shard.

Communication happens where it pays: `shard_server_key` broadcasts the
prepared keys from the mesh's first rank, and the block-sharded radix add
sends carry states between neighbouring ranks at every round of its carry
scan.  `checkpoint` makes a long job resumable.
"""

from .mesh import create_mesh, initialize_multihost, local_mesh
from .sharding import (
    batch_spec,
    key_shardings,
    replicated,
    shard_batch,
    shard_server_key,
)
from .fused import (fused_ks_pbs, fused_radix_add, fused_radix_mul,
                    fused_strings_contains, make_blockshard_radix_add,
                    make_sharded_radix_add, make_sharded_radix_mul,
                    make_sharded_strings_contains)
from .checkpoint import (
    CheckpointManager,
    DeviceFailure,
    ResumableBatchRunner,
)

__all__ = [
    "create_mesh",
    "initialize_multihost",
    "local_mesh",
    "batch_spec",
    "key_shardings",
    "replicated",
    "shard_batch",
    "shard_server_key",
    "fused_ks_pbs",
    "fused_radix_add",
    "make_blockshard_radix_add",
    "make_sharded_radix_add",
    "make_sharded_radix_mul",
    "make_sharded_strings_contains",
    "fused_radix_mul",
    "fused_strings_contains",
    "CheckpointManager",
    "DeviceFailure",
    "ResumableBatchRunner",
]
