"""The port's integer layer and tfhe_tpu.integer driven in lock step, for
the tests/test_torch_integer*.py files: keys from the same seed in both
packages, every encryption made by both client keys in the same order, and
each op's output compared word for word (tolerance 0) with its degrees and
noise levels before the port's result is decrypted."""

import os

import numpy as np
import pytest
import torch

from tfhe_tpu_torch.ops.torus import to_numpy


@pytest.fixture(autouse=True, scope="module")
def host_path_one_thread():
    """The reference's host path (TFHE_TPU_FUSED_INTEGER=0: its
    single-program radix ops have no counterpart in the port yet), and one
    torch thread for the plain versions' many small ops."""
    old = os.environ.get("TFHE_TPU_FUSED_INTEGER")
    os.environ["TFHE_TPU_FUSED_INTEGER"] = "0"
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    if old is None:
        del os.environ["TFHE_TPU_FUSED_INTEGER"]
    else:
        os.environ["TFHE_TPU_FUSED_INTEGER"] = old


class Pair:
    """Both packages' (client key, server key), made from one seed, driven
    in lock step."""

    def __init__(self, ref_keys, port_keys):
        self.ref, self.port = ref_keys, port_keys

    def enc(self, v, signed=False):
        fn = "encrypt_signed" if signed else "encrypt"
        return getattr(self.ref[0], fn)(v), getattr(self.port[0], fn)(v)

    def enc_bool(self, v):
        return self.ref[0].encrypt_bool(v), self.port[0].encrypt_bool(v)

    def op(self, name, *args):
        """sks.name(*args) in both packages; an argument that is a pair is
        split between them."""
        def side(k):
            return [a[k] if isinstance(a, tuple) else a for a in args]
        return (getattr(self.ref[1], name)(*side(0)),
                getattr(self.port[1], name)(*side(1)))

    def dec(self, pair, how="decrypt"):
        """The port's decryption, after checking that both packages hold
        the same blocks, degrees and noise levels."""
        same(*pair)
        return getattr(self.port[0], how)(pair[1])


def _batch(ct):
    return ct.blocks if hasattr(ct, "blocks") else ct.block


def same(ref_ct, port_ct):
    r, p = _batch(ref_ct), _batch(port_ct)
    assert type(ref_ct).__name__ == type(port_ct).__name__
    assert np.array_equal(np.asarray(r.data), to_numpy(p.data))
    assert np.array_equal(r.degrees, p.degrees)
    assert np.array_equal(r.noise, p.noise)
