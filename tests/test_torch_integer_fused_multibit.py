"""fused_ks_pbs, the single-program ops' PBS batch, on a multi-bit key:
the port (on the CPU) == tfhe_tpu.parallel.fused.fused_ks_pbs word for
word at PARAM_MULTI_BIT_MESSAGE_2_CARRY_2_GROUP_2_TEST, leading axes kept,
each dispatching to its package's multi-bit PBS (the reference's through
its shortint key's per-shape PBS program), and decrypted right."""

import numpy as np

import tfhe_tpu.core.multibit as ref_multibit
import tfhe_tpu.parallel.fused as RF
from tfhe_tpu import shortint as ref_shortint
from tfhe_tpu.params import (
    PARAM_MULTI_BIT_MESSAGE_2_CARRY_2_GROUP_2_TEST as REF_MB)

from tfhe_tpu_torch import shortint
from tfhe_tpu_torch.integer import fused as F
from tfhe_tpu_torch.ops.torus import to_numpy
from tfhe_tpu_torch.params import (
    PARAM_MULTI_BIT_MESSAGE_2_CARRY_2_GROUP_2_TEST as MB)
from torch_integer_pair import host_path_one_thread  # noqa: F401

SEED = 11


def test_fused_ks_pbs_multi_bit(monkeypatch):
    rc, rk = ref_shortint.gen_keys(REF_MB, seed=SEED)
    pc, pk = shortint.gen_keys(MB, seed=SEED, device="cpu")
    monkeypatch.setattr(ref_multibit, "keyswitch_then_multi_bit_pbs",
                        lambda ksk, bsk, acc, flat: rk._pbs_device(flat, acc))
    vals = np.arange(6) % 16
    r_ct = np.asarray(rc.encrypt_batch(vals).data).reshape(2, 3, -1)
    p_ct = pc.encrypt_batch(vals).data.reshape(2, 3, -1)
    assert np.array_equal(r_ct, to_numpy(p_ct))
    f = lambda x: (x + 1) % 4  # noqa: E731
    want = RF.fused_ks_pbs(rk.ksk, rk.bsk, rk.generate_lookup_table(f).acc,
                           r_ct)
    got = F.fused_ks_pbs(pk.ksk, pk.bsk, pk.generate_lookup_table(f).acc,
                         p_ct)
    assert np.array_equal(np.asarray(want), to_numpy(got))
    assert pc.decrypt_batch(got.reshape(6, -1)).tolist() == [
        f(int(v)) for v in vals]
