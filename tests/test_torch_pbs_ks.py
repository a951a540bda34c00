"""Both PBS orders of the port's shortint slice (tfhe_tpu_torch, on the CPU)
== tfhe_tpu, word for word, for classic and multi-bit keys: the insecure
TEST sets as they are (encrypting under the big key: keyswitch, then PBS)
and `dataclasses.replace(..., encryption_key_choice=SMALL)` copies of them
(encrypting under the small key: PBS, then keyswitch), in both packages.
Through the ServerKey (a univariate and a bivariate LUT, one op family),
through `core` (keyswitch_then_pbs / pbs_then_keyswitch and their multi-bit
forms), and with the reference's raw keys carried across by
`weights.server_key_from_reference`."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from tfhe_tpu import core as ref_core
from tfhe_tpu import params as ref_params
from tfhe_tpu import shortint as ref_shortint
from tfhe_tpu.params import EncryptionKeyChoice as RefKeyChoice
from tfhe_tpu.params import PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST as REF_CLASSIC
from tfhe_tpu.params import (
    PARAM_MULTI_BIT_MESSAGE_2_CARRY_2_GROUP_2_TEST as REF_MULTI_BIT)

from tfhe_tpu_torch import core, shortint
from tfhe_tpu_torch.ops.torus import to_numpy
from tfhe_tpu_torch.params import (
    ALL_PARAMETER_SETS, PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST,
    PARAM_MULTI_BIT_MESSAGE_2_CARRY_2_GROUP_2_TEST, EncryptionKeyChoice,
    PBSOrder)
from tfhe_tpu_torch.weights import server_key_from_reference

SEED = 31
VALUES = np.arange(16)
CELLS = [(order, kind) for order in ("pbs_ks", "ks_pbs")
         for kind in ("classic", "multi_bit")]
IDS = [f"{o}-{k}" for o, k in CELLS]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run thousands of small tensor ops; one thread
    each keeps them fast when several test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _params(order, kind):
    ref, port = ((REF_CLASSIC, PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST)
                 if kind == "classic" else
                 (REF_MULTI_BIT, PARAM_MULTI_BIT_MESSAGE_2_CARRY_2_GROUP_2_TEST))
    if order == "pbs_ks":
        ref = dataclasses.replace(ref,
                                  encryption_key_choice=RefKeyChoice.SMALL)
        port = dataclasses.replace(
            port, encryption_key_choice=EncryptionKeyChoice.SMALL)
    return ref, port


@functools.cache
def _keys(order, kind):
    """Both packages' keys from one seed, and VALUES encrypted by both."""
    ref_p, p = _params(order, kind)
    rc, rsk = ref_shortint.gen_keys(ref_p, seed=SEED)
    pc, psk = shortint.gen_keys(p, seed=SEED, device="cpu")
    return rc, rsk, rc.encrypt_batch(VALUES), pc, psk, pc.encrypt_batch(VALUES)


def _same(port_data, ref_data) -> bool:
    return np.array_equal(to_numpy(port_data), np.asarray(ref_data))


@pytest.mark.parametrize("order,kind", CELLS, ids=IDS)
def test_server_key_luts_match_reference(order, kind):
    rc, rsk, rb, pc, psk, pb = _keys(order, kind)
    want_order = (PBSOrder.BOOTSTRAP_KEYSWITCH if order == "pbs_ks"
                  else PBSOrder.KEYSWITCH_BOOTSTRAP)
    assert psk.params.pbs_order is want_order
    assert _same(pb.data, rb.data)
    assert tuple(pb.data.shape) == (16, psk.params.ciphertext_lwe_size)
    f = lambda x: (5 * x + 3) % 16  # noqa: E731
    want = rsk.apply_lookup_table_batch(rb, rsk.generate_lookup_table(f))
    got = psk.apply_lookup_table_batch(pb, psk.generate_lookup_table(f))
    assert _same(got.data, want.data)
    assert np.array_equal(pc.decrypt_batch_message_and_carry(got),
                          f(VALUES))
    g = lambda a, b: (a * b + 1) % 4  # noqa: E731
    lhs, rhs = VALUES % 4, VALUES // 4
    want = rsk.unchecked_bivariate_batch(
        rsk.message_extract_batch(rb), rsk.carry_extract_batch(rb),
        rsk.generate_lookup_table_bivariate(g))
    got = psk.unchecked_bivariate_batch(
        psk.message_extract_batch(pb), psk.carry_extract_batch(pb),
        psk.generate_lookup_table_bivariate(g))
    assert _same(got.data, want.data)
    assert np.array_equal(pc.decrypt_batch(got), g(lhs, rhs))


@pytest.mark.parametrize("order,kind", CELLS, ids=IDS)
def test_core_pipeline_matches_reference(order, kind):
    rc, rsk, rb, pc, psk, pb = _keys(order, kind)
    table = list((3 * VALUES + 2) % 16)
    p = psk.params
    ref_acc, _ = ref_core.make_lut_glwe(table, p.polynomial_size,
                                        p.glwe_size, 16, p.delta)
    acc, _ = core.make_lut_glwe(table, p.polynomial_size, p.glwe_size, 16,
                                p.delta, device="cpu")
    name = {("ks_pbs", "classic"): "keyswitch_then_pbs",
            ("pbs_ks", "classic"): "pbs_then_keyswitch",
            ("ks_pbs", "multi_bit"): "keyswitch_then_multi_bit_pbs",
            ("pbs_ks", "multi_bit"): "multi_bit_pbs_then_keyswitch"}[
                (order, kind)]
    want = np.asarray(jax.jit(getattr(ref_core, name))(
        rsk.ksk, rsk.bsk, ref_acc, rb.data))
    got = getattr(core, name)(psk.ksk, psk.bsk, acc, pb.data)
    assert _same(got, want)
    assert np.array_equal(pc.decrypt_batch_message_and_carry(got), table)
    # the schedules of the key's kind give the same words
    for mode in ("scan1w", "mega") if kind == "classic" else ("scan1",):
        assert torch.equal(getattr(core, name)(psk.ksk, psk.bsk, acc, pb.data,
                                               mode=mode), got)


@pytest.mark.parametrize("order,kind", CELLS, ids=IDS)
def test_weights_carry_keys_across_in_both_orders(order, kind):
    rc, rsk, rb, pc, psk, pb = _keys(order, kind)
    carried = server_key_from_reference(
        psk.params, np.asarray(rsk.raw_bsk), np.asarray(rsk.raw_ksk),
        device="cpu")
    assert torch.equal(carried.raw_bsk, psk.raw_bsk)
    assert torch.equal(carried.raw_ksk, psk.raw_ksk)
    f = lambda x: x // 4  # noqa: E731
    want = rsk.apply_lookup_table_batch(rb, rsk.generate_lookup_table(f))
    got = carried.apply_lookup_table_batch(pb,
                                           carried.generate_lookup_table(f))
    assert _same(got.data, want.data)
    with pytest.raises(ValueError, match="KSK"):
        server_key_from_reference(psk.params, np.asarray(rsk.raw_bsk),
                                  np.asarray(rsk.raw_ksk)[:, :, :-1],
                                  device="cpu")


def test_op_family_in_pbs_then_keyswitch_order():
    rc, rsk, _, pc, psk, _ = _keys("pbs_ks", "classic")
    ra, rb_ = rc.encrypt(3), rc.encrypt(2)
    a, b = pc.encrypt(3), pc.encrypt(2)
    for op, clear in (("mul_lsb", 2), ("add", 1), ("sub", 1), ("lt", 0)):
        want, got = getattr(rsk, op)(ra, rb_), getattr(psk, op)(a, b)
        assert _same(got.data, want.data) and got.degree == want.degree, op
        assert pc.decrypt(got) == clear, op


@pytest.mark.parametrize("name", sorted(ALL_PARAMETER_SETS))
def test_parameter_set_is_copied_verbatim(name):
    p = ALL_PARAMETER_SETS[name]
    ref = getattr(ref_params, name)
    for f in dataclasses.fields(ref):
        ref_v, v = getattr(ref, f.name), getattr(p, f.name)
        if f.name == "encryption_key_choice":
            ref_v, v = ref_v.value, v.value
        assert v == ref_v, f.name
    assert p.ciphertext_lwe_size == ref.ciphertext_lwe_size
    if name == "PARAM_MESSAGE_2_CARRY_2_COMPACT_PK_PBS_KS":
        assert p.pbs_order is PBSOrder.BOOTSTRAP_KEYSWITCH
        assert p.ciphertext_lwe_size == 1025


def test_each_key_kind_takes_its_own_modes():
    for kind, good, bad in (("classic", "mega", "bogus"),
                            ("multi_bit", "scan1", "grid")):
        _, p = _params("pbs_ks", kind)
        cks = shortint.ClientKey(p, seed=1, device="cpu")
        with pytest.raises(ValueError, match="mode"):
            shortint.ServerKey(cks, mode=bad)
        assert shortint.ServerKey(cks, mode=good).mode == good
