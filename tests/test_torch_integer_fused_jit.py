"""One single-program radix op against the reference's compiled program:
IntegerServerKey(fused=True).add_parallelized (on the CPU) == the
reference's IntegerServerKey add with TFHE_TPU_FUSED_INTEGER=1 (its whole
add traced into one `jax.jit` program), word for word with degrees and
noise levels, at PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST with 4 blocks; one
op only, as the reference's whole-op compile is the cost
(tests/test_fused_integer.py)."""

import pytest

from tfhe_tpu import integer as ref_integer
from tfhe_tpu.params import PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST as REF_P

from tfhe_tpu_torch import integer
from tfhe_tpu_torch.params import PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST as P
from torch_integer_pair import Pair, host_path_one_thread  # noqa: F401

NB = 4
SEED = 11


@pytest.fixture(autouse=True)
def reference_fused(monkeypatch):
    monkeypatch.setenv("TFHE_TPU_FUSED_INTEGER", "1")


@pytest.mark.parametrize("x,y", [(200, 100)])
def test_fused_add_against_the_compiled_reference(x, y):
    rc, rk = ref_integer.gen_keys_radix(REF_P, NB, seed=SEED)
    pc, pk = integer.gen_keys_radix(P, NB, seed=SEED, device="cpu")
    keys = Pair((rc, rk), (pc, integer.IntegerServerKey(pk.key, fused=True)))
    out = keys.op("add_parallelized", keys.enc(x), keys.enc(y))
    assert keys.ref[1]._fused_ops is not None  # the compiled program ran
    assert ("add", ((1, NB, P.ciphertext_lwe_size),) * 2) in \
        keys.port[1]._fused_ops._fns
    assert keys.dec(out) == (x + y) % 4 ** NB
