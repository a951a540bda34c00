"""WoPBS's core pieces in both packages from one seed, word for word
(tolerance 0), at WOPBS_PARAM_MESSAGE_2_CARRY_2_TEST, seed 515: the keys
(BSK, KSK and the circuit bootstrap's pfpksk list), bit extraction at
every bit count (the partial-count case of tests/test_wopbs.py), the
circuit bootstrap's GGSW words, the dynamic external product and CMux on a
fresh GGSW, and a WoPBS key carried across from the reference's arrays."""

import numpy as np
import pytest
import torch

from tfhe_tpu.core import wopbs as ref_wop

from tfhe_tpu_torch.core import encrypt as core_enc
from tfhe_tpu_torch.core import wopbs as wop

from torch_wopbs_pair import (  # noqa: F401
    jitted_reference, keys, one_torch_thread, words)

VALUES = np.asarray([0b1010, 0b0111], np.uint64)


@pytest.fixture(scope="module")
def pair():
    (rc, rs, rw), (c, s, w) = keys()
    with jitted_reference():
        ref_bits = np.asarray(rw.extract_bits_batch(
            rc.encrypt_batch(VALUES), 59, 4))
        ref_ggsw = np.asarray(rw.cbs.circuit_bootstrap(ref_bits[:, 0], 63))
    return (rc, rs, rw), (c, s, w), ref_bits, ref_ggsw


def test_keys_equal(pair):
    (rc, rs, rw), (c, s, w), _, _ = pair
    np.testing.assert_array_equal(words(s.raw_bsk), words(rs.raw_bsk))
    np.testing.assert_array_equal(words(s.raw_ksk), words(rs.raw_ksk))
    np.testing.assert_array_equal(words(w.cbs.pfpksk_list),
                                  words(rw.cbs.pfpksk_list))
    assert w.cbs.pfpksk_list.shape == (2, 257, 2, 2, 256)


def test_extract_bits_equal(pair):
    (rc, _, _), (c, _, w), ref_bits, _ = pair
    batch = c.encrypt_batch(VALUES)
    bits = w.extract_bits_batch(batch, 59, 4)
    np.testing.assert_array_equal(words(bits), words(ref_bits))


@pytest.mark.parametrize("n_bits", [1, 2, 3])
def test_extract_bits_partial_counts(pair, n_bits):
    """Fewer bits than the domain: the low n_bits, MSB first, keyswitched
    to the small key at scale 2^63, equal to the reference's words."""
    (rc, _, rw), (c, _, w), _, _ = pair
    with jitted_reference():
        ref = np.asarray(rw.extract_bits_batch(rc.encrypt_batch(VALUES), 59,
                                               n_bits))
    bits = w.extract_bits_batch(c.encrypt_batch(VALUES), 59, n_bits)
    np.testing.assert_array_equal(words(bits), words(ref))
    for bi, v in enumerate(VALUES):
        for j in range(n_bits):
            phase = int(words(core_enc.decrypt_lwe(c.lwe_sk,
                                                   bits[bi, j][None]))[0])
            assert ((phase + (1 << 62)) >> 63) & 1 == \
                (int(v) >> (n_bits - 1 - j)) & 1


def test_circuit_bootstrap_ggsw_equal(pair):
    _, (c, _, w), ref_bits, ref_ggsw = pair
    ggsw = w.cbs.circuit_bootstrap(
        torch.from_numpy(ref_bits[:, 0].copy().view(np.int64)), 63)
    assert ggsw.shape == (2, 2, 2, 2, 256)
    np.testing.assert_array_equal(words(ggsw), words(ref_ggsw))


def test_external_product_and_cmux_dynamic_equal(pair):
    """A fresh GGSW (the circuit bootstrap's) times random GLWEs."""
    _, (_, _, w), _, ref_ggsw = pair
    rng = np.random.default_rng(3)
    glwe = rng.integers(0, 2**64, (2, 2, 256), dtype=np.uint64)
    glwe1 = rng.integers(0, 2**64, (2, 2, 256), dtype=np.uint64)
    t = (lambda a: torch.from_numpy(a.view(np.int64).copy()))
    p = w.params
    np.testing.assert_array_equal(
        words(wop.external_product_dynamic(t(ref_ggsw), t(glwe),
                                           p.cbs_base_log, p.cbs_level)),
        words(ref_wop.external_product_dynamic(ref_ggsw, glwe,
                                               p.cbs_base_log, p.cbs_level)))
    np.testing.assert_array_equal(
        words(wop.cmux_dynamic(t(glwe), t(glwe1), t(ref_ggsw),
                               p.cbs_base_log, p.cbs_level)),
        words(ref_wop.cmux_dynamic(glwe, glwe1, ref_ggsw, p.cbs_base_log,
                                   p.cbs_level)))


def test_pfpks_to_glwe_equal(pair):
    (_, _, rw), (_, _, w), _, _ = pair
    rng = np.random.default_rng(4)
    lwe = rng.integers(0, 2**64, (3, 257), dtype=np.uint64)
    p = w.params
    for o in range(2):
        got = wop.pfpks_to_glwe(w.cbs._matrices[o],
                                torch.from_numpy(lwe.view(np.int64)),
                                p.pfks_base_log, p.pfks_level, 2)
        want = ref_wop.pfpks_to_glwe(rw.cbs.pfpksk_list[o], lwe,
                                     p.pfks_base_log, p.pfks_level)
        np.testing.assert_array_equal(words(got), words(want))


def test_wopbs_key_from_reference(pair):
    """The reference's raw BSK, KSK and pfpksk list carried across
    (`weights.wopbs_key_from_reference`) give the port's own key's words
    and bit extraction."""
    from tfhe_tpu_torch import weights

    (rc, rs, rw), (c, s, w), _, _ = pair
    carried = weights.wopbs_key_from_reference(
        w.params, np.asarray(rs.raw_bsk), np.asarray(rs.raw_ksk),
        np.asarray(rw.cbs.pfpksk_list), device="cpu")
    np.testing.assert_array_equal(words(carried.cbs.pfpksk_list),
                                  words(w.cbs.pfpksk_list))
    batch = c.encrypt_batch(VALUES)
    rc.encrypt_batch(VALUES)  # the two client keys stay in step
    np.testing.assert_array_equal(
        words(carried.extract_bits_batch(batch, 59, 4)),
        words(w.extract_bits_batch(batch, 59, 4)))
    with pytest.raises(ValueError, match="pfpksk of shape"):
        weights.wopbs_key_from_reference(
            w.params, np.asarray(rs.raw_bsk), np.asarray(rs.raw_ksk),
            np.zeros((2, 3, 2, 2, 256), np.uint64), device="cpu")
