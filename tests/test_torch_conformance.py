"""The ciphertexts' conformance checks: the port's ShortintBatch,
RadixCiphertext, SignedRadixCiphertext, BooleanBlock, CrtCiphertext and
the API's FheUint / FheInt / FheBool accept a ciphertext of their own
parameter set, and raise the port's ConformanceError (a
DeserializationError) on a set with other moduli or another LWE size,
where tfhe_tpu's raise its own with the same message."""

import pytest

from tfhe_tpu import api as ref_api
from tfhe_tpu import integer as ref_integer
from tfhe_tpu.params import PARAM_MESSAGE_1_CARRY_1_TEST as REF_OTHER_MOD
from tfhe_tpu.params import PARAM_MESSAGE_2_CARRY_2_KS_PBS as REF_OTHER_SIZE
from tfhe_tpu.params import PARAM_MESSAGE_2_CARRY_2_TEST as REF_P
from tfhe_tpu.utils.serialization import ConformanceError as RefError

from tfhe_tpu_torch import api, integer
from tfhe_tpu_torch.params import PARAM_MESSAGE_1_CARRY_1_TEST as OTHER_MOD
from tfhe_tpu_torch.params import PARAM_MESSAGE_2_CARRY_2_KS_PBS as OTHER_SIZE
from tfhe_tpu_torch.params import PARAM_MESSAGE_2_CARRY_2_TEST as P
from tfhe_tpu_torch.utils.serialization import (ConformanceError,
                                                DeserializationError)

SEED = 999


@pytest.fixture(scope="module")
def ciphertexts():
    """(reference, port) pairs of every ciphertext type, encrypted only."""
    rc, _ = ref_integer.gen_keys_radix(REF_P, 4, seed=SEED)
    pc = integer.RadixClientKey(P, 4, seed=SEED, device="cpu")
    rcrt = ref_integer.CrtClientKey(REF_P, [2, 3], seed=SEED)
    pcrt = integer.CrtClientKey(P, [2, 3], seed=SEED, device="cpu")
    ref_cfg = ref_api.ConfigBuilder.default().use_custom_parameters(
        REF_P).build()
    cfg = api.ConfigBuilder.default().use_custom_parameters(P).build()
    ref_hl = ref_api.ClientKey(ref_cfg, seed=SEED)
    hl = api.ClientKey(cfg, seed=SEED, device="cpu")
    pairs = {
        "shortint": (rc.encrypt(5).blocks, pc.encrypt(5).blocks),
        "radix": (rc.encrypt(5), pc.encrypt(5)),
        "signed": (rc.encrypt_signed(-5), pc.encrypt_signed(-5)),
        "bool": (rc.encrypt_bool(True), pc.encrypt_bool(True)),
        "crt": (rcrt.encrypt(5), pcrt.encrypt(5)),
        "FheUint8": (ref_api.FheUint8.encrypt(7, ref_hl),
                     api.FheUint8.encrypt(7, hl)),
        "FheInt16": (ref_api.FheInt16.encrypt(-7, ref_hl),
                     api.FheInt16.encrypt(-7, hl)),
        "FheBool": (ref_api.FheBool.encrypt(True, ref_hl),
                    api.FheBool.encrypt(True, hl)),
    }
    return pairs


KINDS = ("shortint", "radix", "signed", "bool", "crt", "FheUint8",
         "FheInt16", "FheBool")


@pytest.mark.parametrize("kind", KINDS)
def test_conformance_check_accepts_own_and_refuses_other_sets(ciphertexts,
                                                              kind):
    ref_ct, ct = ciphertexts[kind]
    assert type(ref_ct).__name__ == type(ct).__name__
    ref_ct._conformance_check(REF_P)
    ct._conformance_check(P)
    for ref_other, other in ((REF_OTHER_MOD, OTHER_MOD),
                             (REF_OTHER_SIZE, OTHER_SIZE)):
        with pytest.raises(RefError) as ref_err:
            ref_ct._conformance_check(ref_other)
        with pytest.raises(ConformanceError) as err:
            ct._conformance_check(other)
        assert str(err.value) == str(ref_err.value)
        assert isinstance(err.value, DeserializationError)
