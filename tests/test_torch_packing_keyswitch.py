"""The LWE -> GLWE packing keyswitch (the case of
tests/test_packing_keyswitch.py) in both packages from the same seeds:
the packing keyswitch key and the packed GLWE, of a list and of one
ciphertext, equal word for word (tolerance 0), then decrypted."""

import numpy as np
import torch

from tfhe_tpu import core as ref_core
from tfhe_tpu.prng.generators import (
    EncryptionRandomGenerator as RefEncGen,
    SecretRandomGenerator as RefSecGen)
from tfhe_tpu.prng.stream import Seeder as RefSeeder

from tfhe_tpu_torch import core
from tfhe_tpu_torch.prng.generators import (EncryptionRandomGenerator,
                                            SecretRandomGenerator)
from tfhe_tpu_torch.prng.stream import Seeder

from torch_wopbs_pair import one_torch_thread, words  # noqa: F401

N_IN, K, N, BL, L = 24, 1, 64, 12, 3
MSG_MOD = 16
DELTA = (1 << 63) // MSG_MOD
STD = 9.1e-13


def _keys(core_mod, sec_cls, enc_cls, seeder_cls, **dev):
    sgen = sec_cls(11)
    lwe_sk = core_mod.generate_binary_lwe_secret_key(N_IN, sgen, **dev)
    glwe_sk = core_mod.generate_binary_glwe_secret_key(K, N, sgen, **dev)
    egen = enc_cls(5, seeder_cls(5))
    pksk = core_mod.generate_packing_keyswitch_key(lwe_sk, glwe_sk, BL, L,
                                                   STD, egen)
    return lwe_sk, glwe_sk, egen, pksk


def test_pack_lwe_list_into_glwe():
    r_lwe, r_glwe, r_gen, r_pksk = _keys(ref_core, RefSecGen, RefEncGen,
                                         RefSeeder)
    lwe_sk, glwe_sk, egen, pksk = _keys(core, SecretRandomGenerator,
                                        EncryptionRandomGenerator, Seeder,
                                        device="cpu")
    assert pksk.shape == (N_IN, L, K + 1, N)
    np.testing.assert_array_equal(words(pksk), words(r_pksk))

    msgs = np.random.default_rng(0).integers(0, MSG_MOD, 8)
    enc = msgs.astype(np.uint64) * np.uint64(DELTA)
    r_cts = np.asarray(ref_core.encrypt_lwe(r_lwe, enc, STD, r_gen))
    cts = core.encrypt_lwe(lwe_sk, enc, STD, egen)
    np.testing.assert_array_equal(words(cts), words(r_cts))

    glwe = core.packing_keyswitch(pksk, BL, cts)
    np.testing.assert_array_equal(
        words(glwe), words(ref_core.packing_keyswitch(r_pksk, BL, r_cts)))
    decoded = words(core.decrypt_glwe(glwe_sk, glwe[None]))[0]
    vals = ((decoded + np.uint64(DELTA // 2)) >> np.uint64(63 - 4)) % \
        np.uint64(MSG_MOD)
    np.testing.assert_array_equal(vals[:8], msgs)

    # one ciphertext: its message at X^0
    g1 = core.packing_keyswitch(pksk, BL, cts[0])
    np.testing.assert_array_equal(
        words(g1), words(ref_core.packing_keyswitch(r_pksk, BL, r_cts[0])))
    d1 = int(words(core.decrypt_glwe(glwe_sk, g1[None]))[0, 0])
    assert ((d1 + DELTA // 2) >> (63 - 4)) % MSG_MOD == msgs[0]


def test_refuses_more_ciphertexts_than_coefficients():
    import pytest

    with pytest.raises(ValueError, match="coefficients"):
        core.packing_keyswitch(torch.zeros((2, 1, 2, 4), dtype=torch.int64),
                               12, torch.zeros((5, 3), dtype=torch.int64))
