"""Vertical packing in both packages on the same circuit-bootstrapped
GGSWs, word for word (tolerance 0), at WOPBS_PARAM_MESSAGE_2_CARRY_2_TEST,
seed 515: 1, 3 and 4 LUT polynomials (3 zero-padded to the tree width of
4), and several output LUTs sharing one extraction and circuit bootstrap
(the vertical-packing cases of tests/test_wopbs.py)."""

import numpy as np
import pytest
import torch

from tfhe_tpu.core import wopbs as ref_wop

from tfhe_tpu_torch.core import wopbs as wop

from torch_wopbs_pair import (  # noqa: F401
    jitted_reference, keys, one_torch_thread, words)

VALUES = [0b0110, 0b1011, 5]
N_BITS = 4


@pytest.fixture(scope="module")
def ggsws():
    """Both packages' GGSW lists of the same values (MSB first); the
    reference's extraction and circuit bootstrap are checked against the
    port's in tests/test_torch_wopbs.py."""
    (rc, _, rw), (c, _, w) = keys()
    with jitted_reference():
        bits = rw.extract_bits_batch(rc.encrypt_batch(np.asarray(
            VALUES, np.uint64)), 59, N_BITS)
        ref = [np.asarray(rw.cbs.circuit_bootstrap(bits[:, j], 63))
               for j in range(N_BITS)]
    port = [torch.from_numpy(g.view(np.int64).copy()) for g in ref]
    return c, w, ref, port


def _luts(count, N, delta):
    return np.stack([np.full(N, i + 1, np.uint64)
                     for i in range(count)]) * np.uint64(delta)


@pytest.mark.parametrize("count", [1, 3, 4])
def test_vertical_packing_lut_counts(ggsws, count):
    """count constant LUT polynomials lut[i] = i + 1: the tree's MSB bits
    pick the LUT (3 is zero-padded to 4), the rest rotate."""
    c, w, ref, port = ggsws
    p = w.params
    luts = _luts(count, p.polynomial_size, p.delta)
    got = wop.vertical_packing(luts, port, p.glwe_size, p.cbs_base_log,
                               p.cbs_level)
    want = ref_wop.vertical_packing(luts, ref, p.glwe_size, p.cbs_base_log,
                                    p.cbs_level)
    np.testing.assert_array_equal(words(got), words(want))
    dec = c.decrypt_batch_message_and_carry(got)
    tree = {1: 0, 3: 2, 4: 2}[count]
    for v, d in zip(VALUES, dec):
        idx = v >> (N_BITS - tree)
        assert d == (idx + 1 if idx < count else 0)


def test_vertical_packing_multi_output_shared_cbs(ggsws):
    """Several output LUTs reuse one extraction and circuit bootstrap."""
    c, w, ref, port = ggsws
    p = w.params
    for f in (lambda x: (x * x) % 16, lambda x: (x + 7) % 16):
        lut = w.generate_lut_full_domain(f)
        got = wop.vertical_packing(lut.polys, port, p.glwe_size,
                                   p.cbs_base_log, p.cbs_level)
        np.testing.assert_array_equal(
            words(got), words(ref_wop.vertical_packing(
                lut.polys, ref, p.glwe_size, p.cbs_base_log, p.cbs_level)))
        assert c.decrypt_batch_message_and_carry(got).tolist() == \
            [f(v) for v in VALUES]


def test_cmux_tree_and_blind_rotation_equal(ggsws):
    """The two halves of the packing on their own."""
    _, w, ref, port = ggsws
    p = w.params
    luts = _luts(4, p.polynomial_size, p.delta)
    tree = wop.cmux_tree(torch.from_numpy(luts.view(np.int64)), port[:2],
                         p.glwe_size, p.cbs_base_log, p.cbs_level)
    ref_tree = ref_wop.cmux_tree(luts, ref[:2], p.glwe_size, p.cbs_base_log,
                                 p.cbs_level)
    np.testing.assert_array_equal(words(tree), words(ref_tree))
    np.testing.assert_array_equal(
        words(wop.vp_blind_rotate(tree, port[2:], p.cbs_base_log,
                                  p.cbs_level)),
        words(ref_wop.vp_blind_rotate(ref_tree, ref[2:], p.cbs_base_log,
                                      p.cbs_level)))
