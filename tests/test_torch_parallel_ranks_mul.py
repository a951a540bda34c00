"""The port's batch-sharded radix mul on 2 and 4 gloo ranks
(tests/torch_parallel_worker.py) == the reference's unsharded
fused_radix_mul word for word (tolerance 0), at
PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST with 4 blocks, B = 4: every rank
gathers the same words, no rank sends or receives in the step, and the
products decrypt to the clear ones (the sharded mul of
tests/test_mesh.py:81-130)."""

import numpy as np
import pytest

from torch_parallel_pair import (MSG, decrypt_radix, radix_blocks,
                                 ref_keys, run_worlds)

WORLDS = (2, 4)
NB, B = 4, 4


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    cks, sks = ref_keys()
    rng = np.random.default_rng(3)
    xs, ys = (rng.integers(0, MSG**NB, B) for _ in range(2))
    inputs = dict(a=radix_blocks(cks, xs, NB), b=radix_blocks(cks, ys, NB))
    clear = [int(x) * int(y) % MSG**NB for x, y in zip(xs, ys)]
    refs, runs = run_worlds(tmp_path_factory, WORLDS,
                            {"sharded_mul": inputs}, sks)
    ref = refs["sharded_mul"]
    return cks, clear, ref, runs


@pytest.mark.parametrize("world", WORLDS)
def test_batch_sharded_mul(env, world):
    cks, clear, ref, runs = env
    run = runs[world]["sharded_mul"]
    assert decrypt_radix(cks, ref) == clear
    for words in run["words"]:
        np.testing.assert_array_equal(words, ref)
    assert decrypt_radix(cks, run["words"][0]) == clear
    assert [r["p2p_ops"] for r in run["ranks"]] == [0] * world
    # 2 ranks: (2, 1); 4 ranks: the default (batch 2, poly 2) mesh
    assert all(r["local_shape"][:2] == [B // 2, NB] for r in run["ranks"])
