"""The mesh layer on a card: on a one-rank NCCL group (create_mesh on a
private store), the batch-sharded keyswitch + PBS and the block-sharded
radix add (4 blocks, B = 4) give the words of the port's unsharded chains
on the CPU, with keys from one seed at PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST;
with two cards or more, the same adds on two NCCL ranks (one spawned
process a card, tests/torch_parallel_worker.py) give those words too.
Marked `cuda`: it skips where there is no card (and the two-rank case below
two cards); on one, run `python -m pytest -m cuda --noconftest
tests/test_torch_parallel_cuda.py` (tests/conftest.py imports JAX, which is
not needed here)."""

import functools

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tfhe_tpu_torch import parallel, shortint
from tfhe_tpu_torch.ops.torus import to_numpy
from tfhe_tpu_torch.parallel import fused as PF
from tfhe_tpu_torch.parallel.sharding import batch_spec
from tfhe_tpu_torch.params import PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST as P
from torch_parallel_worker import SEED, join_world, spawn_world

pytestmark = pytest.mark.cuda

NB, B = 4, 4
MSG = P.message_modulus


def _inputs(cks):
    rng = np.random.default_rng(5)
    xs, ys = (rng.integers(0, MSG**NB, B) for _ in range(2))

    def blocks(vals):
        return torch.stack([cks.encrypt_batch(
            [(int(v) // MSG**j) % MSG for j in range(NB)]).data
            for v in vals])

    return blocks(xs), blocks(ys), [(int(x) + int(y)) % MSG**NB
                                    for x, y in zip(xs, ys)]


@pytest.fixture(scope="module")
def cpu_words():
    """The port's unsharded chains on the CPU: the LUT batch, the add."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cks, sks = shortint.gen_keys(P, seed=SEED, device="cpu")
    ct = cks.encrypt_batch(np.arange(16) % 4)
    lut = sks.generate_lookup_table(lambda x: (x * 3 + 2) % 4)
    a, b, clear = _inputs(cks)
    accs = PF._carry_accs(sks, torch.device("cpu"))
    add = PF.fused_radix_add(sks.ksk, sks.bsk, *accs, a, b,
                             message_modulus=MSG)
    return dict(
        cts=to_numpy(ct.data),
        pbs=to_numpy(PF.fused_ks_pbs(sks.ksk, sks.bsk, lut.acc, ct.data)),
        a=to_numpy(a), b=to_numpy(b), add=to_numpy(add), clear=clear,
        cks=cks)


@pytest.fixture(scope="module")
def card_keys(cpu_words):
    cks, sks = shortint.gen_keys(P, seed=SEED, device="cuda")
    yield cks, sks
    if dist.is_initialized():
        dist.destroy_process_group()


def test_one_rank_nccl_sharded_pbs_equals_cpu(cpu_words, card_keys):
    cks, sks = card_keys
    mesh = parallel.create_mesh()
    assert dist.get_backend() == "nccl" and tuple(mesh.shape) == (1, 1)
    bsk, ksk = parallel.shard_server_key(mesh, sks.bsk, sks.ksk)
    lut = sks.generate_lookup_table(lambda x: (x * 3 + 2) % 4)
    step, place = PF.bind_to_mesh(mesh, batch_spec(2), functools.partial(
        PF.fused_ks_pbs, ksk, bsk, lut.acc))
    out = step(parallel.shard_batch(mesh, cpu_words["cts"]))
    assert out.to_local().device.type == "cuda"
    assert np.array_equal(to_numpy(out.full_tensor()), cpu_words["pbs"])


def test_one_rank_nccl_blockshard_add_equals_cpu(cpu_words, card_keys):
    cks, sks = card_keys
    mesh = parallel.create_mesh((1,), ("batch",))
    step, place = parallel.make_blockshard_radix_add(mesh, sks, NB)
    PF.reset_p2p_counts()
    out = step(place(cpu_words["a"]), place(cpu_words["b"])).full_tensor()
    assert PF._shift_up_collective.p2p_ops == 0
    assert np.array_equal(to_numpy(out), cpu_words["add"])
    got = [sum(int(d) * MSG**j for j, d in enumerate(cks.decrypt_batch(r)))
           for r in out]
    assert got == cpu_words["clear"]


def test_two_nccl_ranks_equal_cpu(cpu_words, tmp_path):
    if torch.cuda.device_count() < 2:
        pytest.skip("two NCCL ranks need two cards (NCCL refuses two ranks "
                    "on one card, and gloo carries no CUDA tensor)")
    jobs = ("blockshard_add", "sharded_add")
    for job in jobs:
        np.savez(tmp_path / f"{job}_in.npz", a=cpu_words["a"],
                 b=cpu_words["b"])
    join_world(spawn_world(2, str(tmp_path), jobs, device="cuda"), 2)
    for job in jobs:
        for r in range(2):
            assert np.array_equal(np.load(tmp_path / f"{job}_out{r}.npy"),
                                  cpu_words["add"]), (job, r)
