"""The port's dark market (tfhe_tpu_torch.examples.dark_market, on the CPU)
== tfhe_tpu.examples.dark_market, word for word (tolerance 0), at
PARAM_MESSAGE_2_CARRY_2_TEST with 4 blocks and the seed of
tests/test_examples.py: every filled order's blocks, degrees and noise
levels equal before they are decrypted against the clear matching
(torch_integer_pair.py; the reference on its host radix path)."""

import pytest

from tfhe_tpu import integer as ref_integer
from tfhe_tpu.examples import dark_market as ref_dm
from tfhe_tpu.params import PARAM_MESSAGE_2_CARRY_2_TEST as REF_P

from tfhe_tpu_torch import integer
from tfhe_tpu_torch.examples import dark_market as dm
from tfhe_tpu_torch.params import PARAM_MESSAGE_2_CARRY_2_TEST as P
from torch_integer_pair import Pair, host_path_one_thread  # noqa: F401

NB = 4
SEED = 303


def test_dark_market_plain():
    assert dm.volume_match_plain([5, 3, 2], [4, 4]) == ([5, 3, 0], [4, 4])
    assert dm.volume_match_plain([1, 1], [10]) == ([1, 1], [2])
    for sells, buys in (([5, 3, 2], [4, 4]), ([0, 7], [3, 0])):
        assert dm.volume_match_plain(sells, buys) == \
            ref_dm.volume_match_plain(sells, buys)


@pytest.fixture(scope="module")
def keys():
    return Pair(ref_integer.gen_keys_radix(REF_P, NB, seed=SEED),
                integer.gen_keys_radix(P, NB, seed=SEED, device="cpu"))


@pytest.mark.parametrize("sells,buys", [([5, 3, 2], [4, 4]), ([1, 1], [10]),
                                        ([0, 7], [3, 0])])
def test_dark_market_fhe(keys, sells, buys):
    enc_sells = [keys.enc(v) for v in sells]
    enc_buys = [keys.enc(v) for v in buys]
    ref_out = ref_dm.volume_match_fhe(keys.ref[1], [r for r, _ in enc_sells],
                                      [r for r, _ in enc_buys])
    out = dm.volume_match_fhe(keys.port[1], [p for _, p in enc_sells],
                              [p for _, p in enc_buys])
    got = tuple([keys.dec(pair) for pair in zip(r_side, p_side)]
                for r_side, p_side in zip(ref_out, out))
    assert got == dm.volume_match_plain(sells, buys)


def test_run_example(keys):
    """Encrypt, match, decrypt on the port's keys alone."""
    assert dm.run_example(keys.port[0], keys.port[1], [1, 1], [1]) == \
        dm.volume_match_plain([1, 1], [1])
