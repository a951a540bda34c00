"""The shortint casting KeySwitchingKey (the cases of
tests/test_casting.py:18-66) in both packages from the same seeds
(PARAM_MESSAGE_1_CARRY_1_TEST seed 101, PARAM_MESSAGE_2_CARRY_2_TEST
seed 102): the casting key and every cast ciphertext equal word for word,
with degrees (tolerance 0), before the port's is decrypted."""

import numpy as np
import pytest

from tfhe_tpu import shortint as ref_shortint
from tfhe_tpu.params import PARAM_MESSAGE_1_CARRY_1_TEST as REF_1
from tfhe_tpu.params import PARAM_MESSAGE_2_CARRY_2_TEST as REF_2

from tfhe_tpu_torch import shortint
from tfhe_tpu_torch.params import (PARAM_MESSAGE_1_CARRY_1_TEST,
                                   PARAM_MESSAGE_2_CARRY_2_TEST)

from torch_wopbs_pair import (  # noqa: F401
    assert_batches_equal, one_torch_thread, words)


@pytest.fixture
def pairs():
    ref = (ref_shortint.gen_keys(REF_1, seed=101),
           ref_shortint.gen_keys(REF_2, seed=102))
    port = (shortint.gen_keys(PARAM_MESSAGE_1_CARRY_1_TEST, seed=101,
                              device="cpu"),
            shortint.gen_keys(PARAM_MESSAGE_2_CARRY_2_TEST, seed=102,
                              device="cpu"))
    return ref, port


def _ksk(module, src, dst):
    return module.KeySwitchingKey(
        src, dst, module.PARAM_KEYSWITCH_1_1_KS_PBS_TO_2_2_KS_PBS)


def test_cast_up(pairs):
    """1_1 (4 values) -> 2_2 (16 values): keyswitch + right-shift LUT."""
    (r1, r2), (k1, k2) = pairs
    rk, ksk = _ksk(ref_shortint, r1, r2), _ksk(shortint, k1, k2)
    assert ksk.cast_rshift == rk.cast_rshift == 2
    np.testing.assert_array_equal(words(ksk.raw_ksk), words(rk.raw_ksk))
    msgs = np.array([0, 1, 0, 1], dtype=np.uint64)
    ref_out = rk.cast_batch(r1[0].encrypt_batch(msgs))
    out = ksk.cast_batch(k1[0].encrypt_batch(msgs))
    assert_batches_equal(ref_out, out)
    np.testing.assert_array_equal(k2[0].decrypt_batch(out), msgs)
    # the cast ciphertext computes under the destination server key
    sks2 = k2[1]
    res = sks2.apply_lookup_table_batch(
        out, sks2.generate_lookup_table(lambda x: (x + 2) % 4))
    np.testing.assert_array_equal(k2[0].decrypt_batch(res), (msgs + 2) % 4)


def test_cast_down(pairs):
    """2_2 -> 1_1: a scale-up LUT under the source key, then keyswitch."""
    (r1, r2), (k1, k2) = pairs
    rk, ksk = _ksk(ref_shortint, r2, r1), _ksk(shortint, k2, k1)
    assert ksk.cast_rshift == -2
    msgs = np.array([0, 1, 1, 0], dtype=np.uint64)
    ref_out = rk.cast_batch(r2[0].encrypt_batch(msgs))
    out = ksk.cast_batch(k2[0].encrypt_batch(msgs))
    assert_batches_equal(ref_out, out)
    np.testing.assert_array_equal(k1[0].decrypt_batch(out), msgs)


def test_cast_single(pairs):
    (r1, r2), (k1, k2) = pairs
    rk, ksk = _ksk(ref_shortint, r1, r2), _ksk(shortint, k1, k2)
    ref_out = rk.cast(r1[0].encrypt(1))
    out = ksk.cast(k1[0].encrypt(1))
    np.testing.assert_array_equal(words(out.data), words(ref_out.data))
    assert out.degree == ref_out.degree
    assert k2[0].decrypt(out) == 1
