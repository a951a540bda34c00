"""The shortint WoPBS cases of tests/test_wopbs.py on batches of four in
both packages from one seed (WOPBS_PARAM_MESSAGE_2_CARRY_2_TEST, seed 515): every output
equal to the reference's word for word, with its degrees (tolerance 0),
before the port's is decrypted.  The reference file is `slow`; these run
at its toy size in tier 1."""

import numpy as np
import pytest

from torch_wopbs_pair import (  # noqa: F401
    assert_batches_equal, jitted_reference, keys, one_torch_thread)


@pytest.fixture(scope="module")
def pair():
    return keys()


def _both(pair, run):
    (rc, rs, rw), (c, s, w) = pair
    with jitted_reference():
        ref = run(rc, rs, rw)
    return ref, run(c, s, w)


def test_wopbs_function(pair):
    msgs = np.array([0, 1, 2, 3], dtype=np.uint64)

    def run(cks, sks, wk):
        lut = wk.generate_lut(lambda x: (x * 3 + 1) % 4)
        return wk.wopbs_batch(cks.encrypt_batch(msgs), lut)

    ref, got = _both(pair, run)
    assert_batches_equal(ref, got)
    np.testing.assert_array_equal(pair[1][0].decrypt_batch(got),
                                  (msgs * 3 + 1) % 4)


def test_wopbs_full_domain(pair):
    """A LUT over the packed (message, carry) value."""
    msgs = np.array([0, 3, 7, 15], dtype=np.uint64)

    def run(cks, sks, wk):
        lut = wk.generate_lut_full_domain(lambda x: (x * x) % 16)
        return wk.wopbs_batch(cks.encrypt_batch(msgs), lut)

    ref, got = _both(pair, run)
    assert_batches_equal(ref, got)
    np.testing.assert_array_equal(
        pair[1][0].decrypt_batch_message_and_carry(got), (msgs * msgs) % 16)
