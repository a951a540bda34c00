"""The port's mesh ops on 2 and 4 gloo ranks (one spawned process a rank,
a FileStore, tests/torch_parallel_worker.py) == the reference's unsharded
chains word for word (tolerance 0), at PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST:
the block-sharded radix add at 8 blocks, B = 4, whose carry scan sends
carry states between ranks (2 ranks: the halo and a whole-shard move; 4
ranks: whole-shard moves by 1 and 2 ranks and the halo), with each rank's
point-to-point ops as the shift schedule says; and the batch-sharded add
at 4 blocks, with none.  Every rank gathers the same words, and they
decrypt to the clear sums.  The counterpart of tests/test_multihost.py,
at a size that runs in the fast tier."""

import numpy as np
import pytest

from torch_parallel_pair import (MSG, decrypt_radix, radix_blocks,
                                 ref_keys, run_worlds)

WORLDS = (2, 4)
B = 4
# the 8-block add shifts carry states by d = 1, 2, 4 (the resolve rounds)
# and 1 (the carry-in).  2 ranks, 4 blocks each: four shifts of one
# send (rank 0) and one receive (rank 1): halo, halo, whole shard, halo.
# 4 ranks, 2 blocks each: d = 1 and 2 halo / a move by 1 (inner ranks send
# and receive, the ends one of the two), d = 4 a move by 2 (every rank
# sends or receives once), and the carry-in's halo.
P2P = {2: [4, 4], 4: [4, 7, 7, 4]}


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    cks, sks = ref_keys()
    rng = np.random.default_rng(5)
    clear, jobs = {}, {}
    for job, nb in (("blockshard_add", 8), ("sharded_add", 4)):
        xs, ys = (rng.integers(0, MSG**nb, B) for _ in range(2))
        jobs[job] = dict(a=radix_blocks(cks, xs, nb),
                         b=radix_blocks(cks, ys, nb))
        clear[job] = [(int(x) + int(y)) % MSG**nb for x, y in zip(xs, ys)]
    refs, runs = run_worlds(tmp_path_factory, WORLDS, jobs, sks)
    return cks, clear, refs, runs


def _check(env, world, job):
    cks, clear, refs, runs = env
    run = runs[world][job]
    assert decrypt_radix(cks, refs[job]) == clear[job]
    for words in run["words"]:
        np.testing.assert_array_equal(words, refs[job])
    assert decrypt_radix(cks, run["words"][0]) == clear[job]
    return run["ranks"]


@pytest.mark.parametrize("world", WORLDS)
def test_blockshard_add_carry_scan_across_ranks(env, world):
    ranks = _check(env, world, "blockshard_add")
    assert [r["p2p_ops"] for r in ranks] == P2P[world]
    # each rank holds every integer's share of the blocks
    assert all(r["local_shape"][:2] == [B, 8 // world] for r in ranks)


@pytest.mark.parametrize("world", WORLDS)
def test_batch_sharded_add(env, world):
    ranks = _check(env, world, "sharded_add")
    assert [r["p2p_ops"] for r in ranks] == [0] * world
    # 2 ranks: (2, 1); 4 ranks: the default (batch 2, poly 2) mesh
    assert all(r["local_shape"][:2] == [B // 2, 4] for r in ranks)


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_shape_rule_across_ranks(env, world):
    facts = env[3][world]["mesh"]
    # poly = 2 for an even world above 1 (tfhe_tpu/parallel/mesh.py:35-49)
    assert all(f["default_shape"] == [world // 2, 2] for f in facts)
    assert all(f.get("wrong_size_refused") for f in facts)
    # the mesh over the first rank holds rank 0 alone
    assert [f["local_mesh_1_coordinate"] for f in facts] == \
        [[0, 0]] + [None] * (world - 1)
