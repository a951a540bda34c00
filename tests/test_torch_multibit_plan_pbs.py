"""A whole multi-bit PBS on the key the parameter set's widths give (four of
`ntt.WIDE_PRIMES`, one plane: `ntt.classic_plan` for a key word summed
from 2^gf words) == tfhe_tpu's shortint PBS, bit for bit, on the CPU, at
the widths of PARAM_MULTI_BIT_MESSAGE_2_CARRY_2_GROUP_2_KS_PBS and
..._GROUP_3_KS_PBS (N = 2048, base_log 22 and 21) with the LWE dimension
cut to two groups, so that the reference runs in seconds here: keys
carried across from tfhe_tpu.shortint.gen_keys, a univariate LUT on the
16 messages in both schedules, the output words equal to the reference's
and to the five-prime key's, and every one decrypting to the clear
function."""

import dataclasses

import numpy as np
import pytest
import torch

from tfhe_tpu import params as ref_params
from tfhe_tpu import shortint as ref_shortint

from tfhe_tpu_torch import core, params, shortint
from tfhe_tpu_torch.ops import fused_multibit, ntt
from tfhe_tpu_torch.ops.torus import to_numpy, to_tensor
from tfhe_tpu_torch.weights import (client_key_from_reference,
                                    server_key_from_reference)

SETS = ["PARAM_MULTI_BIT_MESSAGE_2_CARRY_2_GROUP_2_KS_PBS",
        "PARAM_MULTI_BIT_MESSAGE_2_CARRY_2_GROUP_3_KS_PBS"]
GROUPS = 2
MSGS = np.arange(16)


@pytest.mark.parametrize("name", SETS, ids=["GROUP_2", "GROUP_3"])
def test_pbs_on_the_planned_key_matches_the_reference(name):
    gf = getattr(params, name).grouping_factor
    ref_p = dataclasses.replace(getattr(ref_params, name),
                                lwe_dimension=GROUPS * gf)
    p = dataclasses.replace(getattr(params, name), lwe_dimension=GROUPS * gf)
    rc, rsk = ref_shortint.gen_keys(ref_p, seed=5)
    raw_bsk, raw_ksk = np.asarray(rsk.raw_bsk), np.asarray(rsk.raw_ksk)
    sks = server_key_from_reference(p, raw_bsk, raw_ksk, device="cpu")
    cks = client_key_from_reference(p, rc.lwe_sk.bits_array,
                                    rc.glwe_sk.bits_array, seed=1,
                                    device="cpu")
    assert (sks.bsk.primes, sks.bsk.planes) == (ntt.WIDE_PRIMES[:4], 1)
    assert tuple(sks.bsk.kspec.shape) == (GROUPS, 1 << gf, 4, 2, 2, 1, 2048)

    f = lambda x: (3 * x + 5) % 16  # noqa: E731
    rb = rc.encrypt_batch(MSGS)
    want = rsk.apply_lookup_table_batch(rb, rsk.generate_lookup_table(f))
    batch = shortint.ShortintBatch(
        data=to_tensor(rb.data, "cpu"), degrees=rb.degrees.copy(),
        message_modulus=rb.message_modulus, carry_modulus=rb.carry_modulus)
    lut = sks.generate_lookup_table(f)
    got = sks.apply_lookup_table_batch(batch, lut)
    assert np.array_equal(to_numpy(got.data), want.data)
    assert np.array_equal(cks.decrypt_batch_message_and_carry(got),
                          [f(int(m)) for m in MSGS])

    # scan1 on the same key, and both schedules on the five-prime key (two
    # planes), give the same words
    five = fused_multibit.prepare_multi_bit_bsk_cuda(
        to_tensor(raw_bsk, "cpu"), p.pbs_base_log, gf, ntt.PRIMES)
    for key in (sks.bsk, five):
        for mode in fused_multibit.MODES:
            out = core.keyswitch_then_multi_bit_pbs(sks.ksk, key, lut.acc,
                                                    batch.data, mode=mode)
            assert torch.equal(out, got.data), (key.primes, mode)
