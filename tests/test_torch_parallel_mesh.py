"""The port's mesh layer in one process, on a world of one gloo rank (the
group create_mesh starts on a private store): mesh construction and its
shape rule, initialize_multihost, the batch-sharded keyswitch + PBS == the
unsharded core.keyswitch_then_pbs == the reference's sharded result on its
8-device CPU mesh (tests/test_mesh.py:33-54) word for word (tolerance 0),
the block-sharded add at one rank == the unsharded chain with no
point-to-point op, the steps' refusal of inputs laid out otherwise, and the
entry points' refusal to run without a card unless asked for the CPU, or
on gloo for a card, at PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST.  The
multi-rank cases are in tests/test_torch_parallel_ranks*.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import tfhe_tpu.parallel as ref_parallel
from tfhe_tpu import shortint as ref_shortint
from tfhe_tpu.core import keyswitch_then_pbs as ref_ks_pbs
from tfhe_tpu.params import PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST as REF_P

from tfhe_tpu_torch import parallel, shortint
from tfhe_tpu_torch.core import keyswitch_then_pbs
from tfhe_tpu_torch.ops.torus import to_numpy
from tfhe_tpu_torch.parallel import fused as PF
from tfhe_tpu_torch.parallel import mesh as mesh_mod
from tfhe_tpu_torch.parallel.sharding import batch_spec
from tfhe_tpu_torch.params import PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST as P

SEED = 8080


@pytest.fixture(scope="module", autouse=True)
def world_of_one():
    """One torch thread for the plain versions, and no process group left
    behind for the next module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def keys():
    return (ref_shortint.gen_keys(REF_P, seed=SEED),
            shortint.gen_keys(P, seed=SEED, device="cpu"))


def test_mesh_construction():
    mesh = parallel.create_mesh(device="cpu")
    assert mesh.mesh_dim_names == ("batch", "poly")
    assert tuple(mesh.shape) == (1, 1) and mesh.size() == 1
    assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
    assert tuple(parallel.create_mesh(axis_names=("batch",),
                                      device="cpu").shape) == (1,)
    assert tuple(parallel.create_mesh(axis_names=("dp", "batch", "poly"),
                                      device="cpu").shape) == (1, 1, 1)
    assert tuple(parallel.local_mesh(1, device="cpu").shape) == (1, 1)
    with pytest.raises(ValueError, match="device count 1"):
        parallel.create_mesh((2, 1), device="cpu")
    # placements: Shard(0) on the named axis, Replicate elsewhere
    sh, rep = parallel.batch_spec(3), parallel.replicated(mesh)
    assert [type(p).__name__ for p in sh] == ["Shard", "Replicate"]
    assert sh[0].dim == 0
    assert [type(p).__name__ for p in rep] == ["Replicate", "Replicate"]


def test_initialize_multihost(monkeypatch):
    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **kw: calls.append((a, kw)))
    for n in (None, 0, 1):  # one process: nothing to join
        assert parallel.initialize_multihost("localhost:1", n, 0,
                                             device="cpu") is None
    assert calls == []
    parallel.initialize_multihost("localhost:29511", 4, 3, device="cpu")
    assert calls == [(("gloo",), dict(init_method="tcp://localhost:29511",
                                      world_size=4, rank=3))]
    with pytest.raises(ValueError):
        parallel.initialize_multihost(None, 2, 0, device="cpu")


def test_batch_sharded_ks_pbs_matches_unsharded_and_reference(keys):
    (rcks, rsks), (cks, sks) = keys
    msgs = np.arange(16) % 4
    rct, ct = rcks.encrypt_batch(msgs), cks.encrypt_batch(msgs)
    assert np.array_equal(rct.data, to_numpy(ct.data))
    lut = sks.generate_lookup_table(lambda x: (x * 3 + 2) % 4)

    mesh = parallel.create_mesh(device="cpu")
    bsk, ksk = parallel.shard_server_key(mesh, sks.bsk, sks.ksk)
    data = parallel.shard_batch(mesh, ct.data)
    step, place = PF.bind_to_mesh(
        mesh, batch_spec(2), functools.partial(PF.fused_ks_pbs, ksk, bsk,
                                               lut.acc))
    out = step(data)
    assert tuple(out.placements) == tuple(data.placements)
    sharded = out.full_tensor()
    plain = keyswitch_then_pbs(sks.ksk, sks.bsk, lut.acc, ct.data)
    assert torch.equal(sharded, plain)
    assert torch.equal(step(place(to_numpy(ct.data))).full_tensor(), plain)
    assert cks.decrypt_batch(sharded).tolist() == ((msgs * 3 + 2) % 4
                                                   ).tolist()

    # the reference's sharded run on its 8-device mesh (test_mesh.py:33-54)
    rmesh = ref_parallel.create_mesh()
    rlut = rsks.generate_lookup_table(lambda x: (x * 3 + 2) % 4)
    rkeys = jax.device_put((rsks.ksk, rsks.bsk),
                           ref_parallel.replicated(rmesh))
    want = np.asarray(jax.jit(ref_ks_pbs)(
        rkeys[0], rkeys[1], rlut.acc,
        ref_parallel.shard_batch(rmesh, jnp.asarray(rct.data))))
    assert np.array_equal(to_numpy(sharded), want)


def test_key_replication_keeps_the_words(keys):
    _, (cks, sks) = keys
    mesh = parallel.create_mesh(device="cpu")
    bsk, ksk = parallel.shard_server_key(mesh, sks.bsk, sks.ksk)
    b_sh, k_sh = parallel.key_shardings(mesh, sks.bsk, sks.ksk)
    assert set(k_sh) == {"matrix"} and b_sh
    for key, got, sh in ((sks.bsk, bsk, b_sh), (sks.ksk, ksk, k_sh)):
        for name in sh:
            assert torch.equal(getattr(got, name), getattr(key, name))
        assert type(got) is type(key)


def test_blockshard_add_at_one_rank(keys):
    _, (cks, sks) = keys
    nb, msg = 4, P.message_modulus
    mesh = parallel.create_mesh((1,), ("batch",), device="cpu")
    step, place = parallel.make_blockshard_radix_add(mesh, sks, nb)
    xs, ys = [200, 37], [100, 219]

    def blocks(vals):
        return torch.stack([cks.encrypt_batch(
            [(v // msg**j) % msg for j in range(nb)]).data for v in vals])

    a, b = blocks(xs), blocks(ys)
    PF.reset_p2p_counts()
    out = step(place(a), place(b)).full_tensor()
    assert PF._shift_up_collective.p2p_ops == 0  # every shift stays local
    accs = PF._carry_accs(sks, torch.device("cpu"))
    want = PF.fused_radix_add(sks.ksk, sks.bsk, *accs, a, b,
                              message_modulus=msg)
    assert torch.equal(out, want)
    got = [sum(int(d) * msg**j for j, d in enumerate(cks.decrypt_batch(r)))
           for r in out]
    assert got == [(x + y) % msg**nb for x, y in zip(xs, ys)]
    # a step takes the DTensors of its own layout only
    with pytest.raises(TypeError):
        step(a, b)
    bad = parallel.shard_batch(mesh, a)  # Shard(0), not the blocks' Shard(1)
    with pytest.raises(ValueError, match="laid out"):
        step(bad, bad)


def test_entry_points_need_a_card_unless_asked_for_the_cpu(tmp_path,
                                                           monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card refusal cannot be shown")
    for call in (lambda: parallel.create_mesh(),
                 lambda: parallel.local_mesh(),
                 lambda: parallel.initialize_multihost("localhost:1", 2, 0),
                 lambda: parallel.CheckpointManager(str(tmp_path))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    with pytest.raises(parallel.DeviceFailure):
        parallel.checkpoint.default_health_check(torch.device("cuda"))
    # a card's mesh never runs on a gloo group
    parallel.create_mesh(device="cpu")
    monkeypatch.setattr(mesh_mod, "resolve_device",
                        lambda device: torch.device("cuda", 0))
    with pytest.raises(RuntimeError, match="nccl"):
        parallel.create_mesh()
