"""The core's widest digit counts on the plain path: a LUT batch at the
WoPBS catalog's L*G = 18 (PARAM_4_BITS_5_BLOCKS: N = 1024, k = 2, six
levels of base_log 7) and L*G = 12 (WOPBS_PARAM_MESSAGE_1_NORM2_6_KS_PBS:
N = 512, k = 3, three levels of 9), each at a toy n = 4, equal word for
word (tolerance 0) to the reference's LUT batch on the same keys, in every
classic schedule; K1's plain version at six levels of base_log 7 against
the reference's rotation and decomposition; and the CUDA wrappers' limits:
the classic kernels on the core take up to 18 digit polynomials, the
multi-bit ones 9, and past that a wrapper raises naming its limit."""

import dataclasses

import numpy as np
import pytest
import torch

from tfhe_tpu import shortint as ref_shortint
from tfhe_tpu.ops import decomposition as ref_dec
from tfhe_tpu.ops import polymul as ref_polymul
from tfhe_tpu.params import wopbs_params as ref_wopbs_params

from tfhe_tpu_torch import core, shortint
from tfhe_tpu_torch.ops import fused_pbs
from tfhe_tpu_torch.params import wopbs_params

from torch_wopbs_pair import one_torch_thread, words  # noqa: F401

SEED = 77
WIDE = ("PARAM_4_BITS_5_BLOCKS", "WOPBS_PARAM_MESSAGE_1_NORM2_6_KS_PBS")


@pytest.mark.parametrize("name", WIDE)
def test_wide_digit_lut_batch_equals_reference(name):
    ref_p = dataclasses.replace(getattr(ref_wopbs_params, name),
                                lwe_dimension=4)
    p = dataclasses.replace(getattr(wopbs_params, name), lwe_dimension=4)
    assert p.pbs_level * p.glwe_size in (12, 18)
    rc, rs = ref_shortint.gen_keys(ref_p, seed=SEED)
    c, s = shortint.gen_keys(p, seed=SEED, device="cpu")
    assert s.mode == "scan2"
    msgs = np.arange(8) % p.total_modulus
    f = (lambda x: (x + 1) % p.total_modulus)
    ref_out = rs.apply_lookup_table_batch(rc.encrypt_batch(msgs),
                                          rs.generate_lookup_table(f))
    out = s.apply_lookup_table_batch(c.encrypt_batch(msgs),
                                     s.generate_lookup_table(f))
    np.testing.assert_array_equal(words(out.data), words(ref_out.data))
    np.testing.assert_array_equal(out.degrees, ref_out.degrees)
    np.testing.assert_array_equal(c.decrypt_batch_message_and_carry(out),
                                  (msgs + 1) % p.total_modulus)
    # every classic schedule's plain versions give the same words
    data = c.encrypt_batch(msgs).data
    acc = s.generate_lookup_table(f).acc
    want = core.keyswitch_then_pbs(s.ksk, s.bsk, acc, data, "scan2")
    for mode in fused_pbs.MODES[1:]:
        assert torch.equal(core.keyswitch_then_pbs(s.ksk, s.bsk, acc, data,
                                                   mode), want), mode


def test_k1_plain_six_levels_of_base_log_7():
    rng = np.random.default_rng(6)
    B, G, N, bl, L = 3, 3, 1024, 7, 6
    acc = rng.integers(0, 2**64, (B, G, N), dtype=np.uint64)
    ahat = rng.integers(0, 2 * N, (B,), endpoint=True).astype(np.int32)
    got = fused_pbs.rotate_decompose_plain(
        torch.from_numpy(acc.view(np.int64)), torch.from_numpy(ahat), bl, L)
    with np.errstate(over="ignore"):
        diff = np.asarray(ref_polymul.monomial_mul(
            acc, ahat[:, None], N)).astype(np.uint64) - acc
    want = np.asarray(ref_dec.signed_decompose(diff, bl, L))  # [B, G, N, L]
    assert got.shape == (B, L, G, N)
    np.testing.assert_array_equal(got.numpy(), want.transpose(0, 3, 1, 2))


def test_digit_limits_name_themselves():
    """Every kernel on the core, classic or multi-bit, takes up to 18
    digit polynomials; a launch its C entry point refuses raises naming
    that limit."""
    assert fused_pbs.MAX_DIGIT_POLYS == 18
    with pytest.raises(RuntimeError, match="^pbs_step: .*InvalidValue.*"
                       "at most 18 digit polynomials"):
        fused_pbs._check_launch(1, "pbs_step")
    with pytest.raises(RuntimeError, match="^multibit_step: .*at most 18 "):
        fused_pbs._check_launch(1, "multibit_step")
    fused_pbs._check_launch(0, "pbs_step")
