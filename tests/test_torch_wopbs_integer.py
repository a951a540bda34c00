"""The integer WoPBS case of tests/test_wopbs.py (`test_integer_wopbs`) in
both packages from one seed (WOPBS_PARAM_MESSAGE_2_CARRY_2_TEST, seed
515): (x * 3 + 5) mod 16 on a 2-block radix, its LUT polynomials and its
output blocks equal to the reference's word for word, with degrees
(tolerance 0), before the port's is decrypted."""

import numpy as np

from tfhe_tpu import integer as ref_integer
from tfhe_tpu.params import WOPBS_PARAM_MESSAGE_2_CARRY_2_TEST as REF_P

from tfhe_tpu_torch import integer
from tfhe_tpu_torch.params import WOPBS_PARAM_MESSAGE_2_CARRY_2_TEST as P

from torch_wopbs_pair import (  # noqa: F401
    assert_batches_equal, jitted_reference, keys, one_torch_thread, words)


def _radix_key(module, params, cks):
    # the WoPBS client key, so the same server keys apply
    return module.RadixClientKey(params, 2, _key=cks)


def test_integer_wopbs():
    (rc, _, rw), (c, _, w) = keys()
    f = (lambda x: (x * 3 + 5) % 16)
    ref_rck = ref_integer.RadixClientKey.__new__(ref_integer.RadixClientKey)
    ref_rck.key, ref_rck.num_blocks, ref_rck.params = rc, 2, REF_P
    rck = _radix_key(integer, P, c)
    ref_iwk = ref_integer.IntegerWopbsKey(rw)
    iwk = integer.IntegerWopbsKey(w)
    ref_ct, ct = ref_rck.encrypt(11), rck.encrypt(11)
    np.testing.assert_array_equal(words(ct.blocks.data),
                                  words(ref_ct.blocks.data))
    ref_lut, lut = ref_iwk.generate_lut(ref_ct, f), iwk.generate_lut(ct, f)
    for a, b in zip(lut.polys_per_block, ref_lut.polys_per_block):
        np.testing.assert_array_equal(a, b)
    with jitted_reference():
        ref_out = ref_iwk.wopbs(ref_ct, ref_lut)
    out = iwk.wopbs(ct, lut)
    assert type(out).__name__ == "RadixCiphertext"
    assert_batches_equal(ref_out.blocks, out.blocks)
    assert rck.decrypt(out) == f(11)
