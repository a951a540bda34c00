"""The shortint WoPBS cases of tests/test_wopbs.py on one ciphertext in
both packages from one seed (WOPBS_PARAM_MESSAGE_2_CARRY_2_TEST, seed 515): every output
equal to the reference's word for word, with its degrees (tolerance 0),
before the port's is decrypted.  The reference file is `slow`; these run
at its toy size in tier 1."""

import numpy as np
import pytest

from torch_wopbs_pair import (  # noqa: F401
    assert_batches_equal, jitted_reference, keys, one_torch_thread, words)


@pytest.fixture(scope="module")
def pair():
    return keys()


def _both(pair, run):
    (rc, rs, rw), (c, s, w) = pair
    with jitted_reference():
        ref = run(rc, rs, rw)
    return ref, run(c, s, w)


def test_wopbs_identity(pair):
    def run(cks, sks, wk):
        lut = wk.generate_lut(lambda x: x)
        return [wk.wopbs(cks.encrypt(v), lut) for v in (1, 2)]

    ref, got = _both(pair, run)
    c = pair[1][0]
    for v, r, g in zip((1, 2), ref, got):
        np.testing.assert_array_equal(words(g.data), words(r.data))
        assert g.degree == r.degree
        assert c.decrypt(g) == v


def test_wopbs_after_arithmetic(pair):
    """A carry-laden ciphertext (3 + 3, degree 6)."""
    def run(cks, sks, wk):
        s = sks.unchecked_add_batch(cks.encrypt_batch([3]),
                                    cks.encrypt_batch([3]))
        lut = wk.generate_lut_full_domain(lambda x: x % 4)
        return wk.wopbs_batch(s, lut)

    ref, got = _both(pair, run)
    assert_batches_equal(ref, got)
    assert pair[1][0].decrypt_batch(got)[0] == 6 % 4
