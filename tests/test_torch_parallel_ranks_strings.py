"""The port's batch-sharded strings contains on 2 and 4 gloo ranks
(tests/torch_parallel_worker.py, meshes (2, 1) and (4, 1)) == the
reference's unsharded fused_strings_contains word for word (tolerance 0),
at PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST on the texts and pattern of
tests/test_mesh.py:133-155: every rank gathers the same words, no rank
sends or receives in the step, and the booleans decrypt to Python's
`in`."""

import numpy as np
import pytest

from torch_parallel_pair import (PATTERN, TEXTS, ref_keys, run_worlds,
                                 text_blocks)

WORLDS = (2, 4)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    cks, sks = ref_keys()
    inputs = dict(chars=text_blocks(cks, TEXTS), pattern=np.array(PATTERN))
    refs, runs = run_worlds(tmp_path_factory, WORLDS, {"contains": inputs},
                            sks)
    ref = refs["contains"]
    return cks, ref, runs


@pytest.mark.parametrize("world", WORLDS)
def test_batch_sharded_strings_contains(env, world):
    cks, ref, runs = env
    run = runs[world]["contains"]
    want = [PATTERN in t for t in TEXTS]
    assert [bool(v) for v in cks.decrypt_batch(ref)] == want
    for words in run["words"]:
        np.testing.assert_array_equal(words, ref)
    assert [bool(v) for v in cks.decrypt_batch(run["words"][0])] == want
    assert [r["p2p_ops"] for r in run["ranks"]] == [0] * world
    assert all(r["local_shape"][0] == len(TEXTS) // world
               for r in run["ranks"])
