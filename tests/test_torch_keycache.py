"""The key cache: a second `gen_keys(..., cache_dir=, seed=)` loads the raw
keys from disk and gives the same words, for shortint, radix, CRT, string
and API keys; the reference's cache file loads in the port and the port's
in the reference (the same file name and arrays); and `utils.KeyCache`
round-trips keys through the wire format under its file lock."""

import numpy as np
import pytest

from tfhe_tpu import shortint as ref_shortint
from tfhe_tpu.params import PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST as REF_P

from tfhe_tpu_torch import api, integer, shortint, strings
from tfhe_tpu_torch.params import PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST as P
from tfhe_tpu_torch.utils import KeyCache

from torch_wopbs_pair import (  # noqa: F401
    assert_batches_equal, one_torch_thread, words)


def _lut_words(cks, sks):
    lut = sks.generate_lookup_table(lambda x: (x + 5) % 16)
    return sks.apply_lookup_table_batch(cks.encrypt_batch(np.arange(8)), lut)


def test_gen_keys_cache_dir_loads_the_same_words(tmp_path):
    c1, s1 = shortint.gen_keys(P, seed=21, device="cpu",
                               cache_dir=str(tmp_path))
    assert (tmp_path / f"{P.name}_s21.npz").exists()
    c2, s2 = shortint.gen_keys(P, seed=21, device="cpu",
                               cache_dir=str(tmp_path))
    np.testing.assert_array_equal(words(s2.raw_bsk), words(s1.raw_bsk))
    np.testing.assert_array_equal(words(s2.raw_ksk), words(s1.raw_ksk))
    # the loaded client key's generator resumes where keygen left it
    out1, out2 = _lut_words(c1, s1), _lut_words(c2, s2)
    assert_batches_equal(out1, out2)
    np.testing.assert_array_equal(c2.decrypt_batch_message_and_carry(out2),
                                  (np.arange(8) + 5) % 16)


def test_cache_file_is_shared_with_the_reference(tmp_path):
    rc, rs = ref_shortint.gen_keys(REF_P, seed=22, cache_dir=str(tmp_path))
    c, s = shortint.gen_keys(P, seed=22, device="cpu",
                             cache_dir=str(tmp_path))
    np.testing.assert_array_equal(words(s.raw_bsk), words(rs.raw_bsk))
    other = tmp_path / "port"
    c, s = shortint.gen_keys(P, seed=23, device="cpu", cache_dir=str(other))
    rc, rs = ref_shortint.gen_keys(REF_P, seed=23, cache_dir=str(other))
    np.testing.assert_array_equal(words(rs.raw_ksk), words(s.raw_ksk))
    np.testing.assert_array_equal(words(rc.encrypt_batch([3]).data),
                                  words(c.encrypt_batch([3]).data))


@pytest.mark.parametrize("layer", ["radix", "crt", "strings", "api"])
def test_every_key_generator_takes_cache_dir(tmp_path, layer):
    def gen():
        if layer == "radix":
            cks, sks = integer.gen_keys_radix(P, 2, seed=24, device="cpu",
                                              cache_dir=str(tmp_path))
            return cks.key, sks.key
        if layer == "crt":
            cks, sks = integer.gen_keys_crt(P, [2, 3], seed=24, device="cpu",
                                            cache_dir=str(tmp_path))
            return cks.key, sks.key
        if layer == "strings":
            cks, sks = strings.gen_keys(P, seed=24, device="cpu",
                                        cache_dir=str(tmp_path))
            return cks.integer_key.key, sks.sks
        cfg = api.ConfigBuilder.default().use_custom_parameters(P).build()
        cks, sks = api.generate_keys(cfg, seed=24, device="cpu",
                                     cache_dir=str(tmp_path))
        return cks.radix.key, sks.integer_key.key

    (c1, s1), (c2, s2) = gen(), gen()
    assert (tmp_path / f"{P.name}_s24.npz").exists()
    np.testing.assert_array_equal(words(s2.raw_bsk), words(s1.raw_bsk))
    assert_batches_equal(_lut_words(c1, s1), _lut_words(c2, s2))


def test_key_cache_round_trips_through_the_wire_format(tmp_path):
    cache = KeyCache(str(tmp_path))
    c1, s1 = cache.get_shortint_keys(P, seed=25, device="cpu")
    assert (tmp_path / f"{P.name}_s25_server.tfhekeys").exists()
    fresh = KeyCache(str(tmp_path))
    c2, s2 = fresh.get_shortint_keys(P, seed=25, device="cpu")
    np.testing.assert_array_equal(words(s2.raw_bsk), words(s1.raw_bsk))
    np.testing.assert_array_equal(words(c2.lwe_sk.bits_array),
                                  words(c1.lwe_sk.bits_array))
    assert c2.decrypt_batch(c1.encrypt_batch([1, 2]))[1] == 2
