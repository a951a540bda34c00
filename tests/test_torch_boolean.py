"""The port's boolean gates (tfhe_tpu_torch.boolean, on the CPU) ==
tfhe_tpu.boolean, word for word, at BOOLEAN_TEST_PARAMETERS: keys and
encryptions from the same seed, every gate's output ciphertexts, in both PBS
orders (the set's own bootstrap-then-keyswitch, and keyswitch-then-bootstrap
on a copy encrypting under the big key); the truth tables, mux, the scalar
API's trivial dispatch, a chain of gates, keys carried across by
`weights.py`, and identical outputs in every blind-rotation schedule.
Cases of tests/test_boolean.py."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from tfhe_tpu import boolean as ref_boolean
from tfhe_tpu import core as ref_core
from tfhe_tpu.params import BOOLEAN_TEST_PARAMETERS as REF_PARAMS
from tfhe_tpu.params import EncryptionKeyChoice as RefKeyChoice

from tfhe_tpu_torch import boolean, weights
from tfhe_tpu_torch.ops.fused_pbs import MODES
from tfhe_tpu_torch.ops.torus import to_numpy, to_tensor
from tfhe_tpu_torch.params import BOOLEAN_TEST_PARAMETERS, EncryptionKeyChoice

SEED = 42
A_BITS = np.array([False, False, True, True])
B_BITS = np.array([False, True, False, True])
C_BITS = np.array([True, False, True, False])
ORDERS = ["pbs_ks", "ks_pbs"]
GATES = [("and", A_BITS & B_BITS), ("or", A_BITS | B_BITS),
         ("xor", A_BITS ^ B_BITS), ("nand", ~(A_BITS & B_BITS)),
         ("nor", ~(A_BITS | B_BITS)), ("xnor", ~(A_BITS ^ B_BITS))]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run thousands of small tensor ops; one thread
    each keeps them fast when several test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _params(order):
    """The test set as it is (SMALL: PBS then keyswitch), or encrypting
    under the big key (BIG: keyswitch then PBS), in both packages."""
    if order == "pbs_ks":
        return REF_PARAMS, BOOLEAN_TEST_PARAMETERS
    return (dataclasses.replace(REF_PARAMS, encryption_key_choice=RefKeyChoice.BIG),
            dataclasses.replace(BOOLEAN_TEST_PARAMETERS,
                                encryption_key_choice=EncryptionKeyChoice.BIG))


@functools.cache
def _keys(order):
    ref_p, p = _params(order)
    return (ref_boolean.gen_keys(ref_p, seed=SEED),
            boolean.gen_keys(p, seed=SEED, device="cpu"))


@functools.cache
def _inputs(order):
    """The same bits encrypted by both client keys (fresh from keygen, so
    both generators stand at the same place)."""
    (rc, _), (c, _) = _keys(order)
    ref = [rc.encrypt_batch(bits) for bits in (A_BITS, B_BITS, C_BITS)]
    port = [c.encrypt_batch(bits) for bits in (A_BITS, B_BITS, C_BITS)]
    return ref, port


@pytest.mark.parametrize("order", ORDERS)
def test_keys_and_encryptions_match_reference(order):
    (rc, _), (c, s) = _keys(order)
    assert np.array_equal(c.lwe_sk.bits_array.numpy(), rc.lwe_sk.bits_array)
    assert np.array_equal(c.glwe_sk.bits_array.numpy(),
                          rc.glwe_sk.bits_array)
    ref, port = _inputs(order)
    for r, t in zip(ref, port):
        assert np.array_equal(to_numpy(t, 32), np.asarray(r))
    assert s.params.pbs_order.value == order
    assert s.device == torch.device("cpu") and s.mode == "scan2"


@pytest.mark.parametrize("gate,expected", GATES, ids=[g for g, _ in GATES])
@pytest.mark.parametrize("order", ORDERS)
def test_gate_matches_reference(order, gate, expected):
    (rc, rs), (c, s) = _keys(order)
    (ra, rb, _), (a, b, _) = _inputs(order)
    want = np.asarray(getattr(rs, f"{gate}_batch")(ra, rb))
    got = getattr(s, f"{gate}_batch")(a, b)
    assert np.array_equal(to_numpy(got, 32), want)
    assert np.array_equal(c.decrypt_batch(got), expected)


@pytest.mark.parametrize("order", ORDERS)
def test_not_and_mux_match_reference(order):
    (rc, rs), (c, s) = _keys(order)
    (ra, rb, rcond), (a, b, cond) = _inputs(order)
    assert np.array_equal(to_numpy(s.not_batch(a), 32),
                          np.asarray(rs.not_batch(ra)))
    assert np.array_equal(c.decrypt_batch(s.not_batch(a)), ~A_BITS)
    got = s.mux_batch(cond, a, b)
    assert np.array_equal(to_numpy(got, 32),
                          np.asarray(rs.mux_batch(rcond, ra, rb)))
    assert np.array_equal(c.decrypt_batch(got), np.where(C_BITS, A_BITS,
                                                         B_BITS))


def test_scalar_api_trivial_dispatch():
    _, (cks, sks) = _keys("pbs_ks")
    t = sks.trivial_encrypt(True)
    f = sks.trivial_encrypt(False)
    e_true = cks.encrypt(True)
    e_false = cks.encrypt(False)
    assert cks.decrypt(sks.and_(t, e_false)) is False
    assert cks.decrypt(sks.and_(t, f)) is False
    assert cks.decrypt(sks.or_(f, e_true)) is True
    assert cks.decrypt(sks.xor(e_true, t)) is False
    assert cks.decrypt(sks.nand(e_true, e_true)) is False
    assert cks.decrypt(sks.mux(e_true, e_false, t)) is False
    assert cks.decrypt(sks.mux(f, e_false, e_true)) is True
    assert cks.decrypt(sks.not_(e_false)) is True
    assert sks.and_(t, f).is_trivial and sks.xnor(t, f).trivial is False
    assert cks.decrypt(sks.mux(e_false, t, e_true)) is True
    assert cks.decrypt(sks.mux(e_true, e_true, f)) is True
    assert cks.decrypt(sks.nor(e_false, e_false)) is True


def test_gate_chain():
    """Noise survives a chain of dependent gates (a full adder over all
    eight input combinations, one batch per gate)."""
    _, (cks, sks) = _keys("pbs_ks")
    a, b, c = (np.array([(i >> k) & 1 for i in range(8)], bool)
               for k in (2, 1, 0))
    ea, eb, ec = (cks.encrypt_batch(v) for v in (a, b, c))
    s1 = sks.xor_batch(ea, eb)
    total = sks.xor_batch(s1, ec)
    carry = sks.or_batch(sks.and_batch(ea, eb), sks.and_batch(s1, ec))
    assert np.array_equal(cks.decrypt_batch(total), a ^ b ^ c)
    assert np.array_equal(cks.decrypt_batch(carry), (a & b) | ((a ^ b) & c))


@functools.cache
def _raw_reference_keys():
    """The reference's boolean ServerKey keeps no raw keys: regenerate them
    from the same seed, in its own order (BSK, then KSK)."""
    p = REF_PARAMS
    rc = ref_boolean.ClientKey(p, seed=SEED)
    bsk = ref_core.generate_bootstrap_key(
        rc.lwe_sk, rc.glwe_sk, p.pbs_base_log, p.pbs_level,
        p.glwe_modular_std_dev, rc._enc_gen)
    ksk = ref_core.generate_keyswitch_key(
        rc.big_sk, rc.lwe_sk, p.ks_base_log, p.ks_level,
        p.lwe_modular_std_dev, rc._enc_gen)
    return rc, np.asarray(bsk), np.asarray(ksk)


def test_keys_carried_across_by_weights():
    rc, bsk, ksk = _raw_reference_keys()
    p = BOOLEAN_TEST_PARAMETERS
    c = weights.boolean_client_key_from_reference(
        p, rc.lwe_sk.bits_array, rc.glwe_sk.bits_array, seed=1, device="cpu")
    s = weights.boolean_server_key_from_reference(p, bsk, ksk, device="cpu")
    (_, rs), _ = _keys("pbs_ks")
    (ra, rb, _), _ = _inputs("pbs_ks")
    a, b = to_tensor(np.asarray(ra), "cpu"), to_tensor(np.asarray(rb), "cpu")
    got = s.nand_batch(a, b)
    assert np.array_equal(to_numpy(got, 32), np.asarray(rs.nand_batch(ra, rb)))
    assert np.array_equal(c.decrypt_batch(got), ~(A_BITS & B_BITS))
    with pytest.raises(ValueError, match="BSK"):
        weights.boolean_server_key_from_reference(p, bsk[1:], ksk,
                                                  device="cpu")
    with pytest.raises(ValueError, match="KSK"):
        weights.boolean_server_key_from_reference(p, bsk, ksk[:, :1],
                                                  device="cpu")
    with pytest.raises(ValueError, match="GLWE key"):
        weights.boolean_client_key_from_reference(
            p, rc.lwe_sk.bits_array, rc.glwe_sk.bits_array[:1], device="cpu")


def test_every_mode_gives_the_same_gates():
    _, bsk, ksk = _raw_reference_keys()
    p = BOOLEAN_TEST_PARAMETERS
    _, (a, b, cond) = _inputs("pbs_ks")
    outs = {}
    for mode in MODES:
        s = weights.boolean_server_key_from_reference(p, bsk, ksk,
                                                      device="cpu", mode=mode)
        assert s.mode == mode
        outs[mode] = s.mux_batch(cond, a, b)
    for mode in MODES:
        assert torch.equal(outs[mode], outs["scan2"])
    with pytest.raises(ValueError, match="mode"):
        boolean.ServerKey.from_raw(p, bsk, ksk, device="cpu", mode="scan4")
    # the public key works: its encryptions decrypt (a client key of its
    # own, so the shared keys' generators stay where the other tests
    # expect them)
    cks = boolean.ClientKey(_params("pbs_ks")[1], seed=SEED + 1,
                            device="cpu")
    pk = boolean.PublicKey(cks)
    bits = np.array([True, False, True])
    ct = pk.encrypt_batch(bits, seed=4)
    np.testing.assert_array_equal(cks.decrypt_batch(ct), bits)
    assert pk.encrypt(True, seed=5).data.shape == ct[0].shape
    assert cks.decrypt(pk.encrypt(True, seed=5)) is True
