"""Both packages' WoPBS keys from one seed, for the lock-step WoPBS tests.

The reference's `core.wopbs` runs its bit extraction and circuit bootstrap
through `programmable_bootstrap` and `keyswitch` op by op, retracing the
blind rotation's scan at every call (about 4.6 s each on the CPU); here
they are replaced, while a test runs, by `jax.jit` of the same functions,
as its server key's LUT path runs them (tfhe_tpu/shortint/server_key.py:
44-47).  Nothing of the JAX package changes."""

import contextlib
import functools

import jax
import numpy as np
import pytest
import torch

from tfhe_tpu import shortint as ref_shortint
from tfhe_tpu.core import wopbs as ref_wop
from tfhe_tpu.params import WOPBS_PARAM_MESSAGE_2_CARRY_2_TEST as REF_P

from tfhe_tpu_torch import shortint
from tfhe_tpu_torch.params import WOPBS_PARAM_MESSAGE_2_CARRY_2_TEST as P

SEED = 515


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain versions run thousands of small tensor ops; one thread
    each keeps them fast when several test workers share the cores (as
    tests/test_torch_boolean.py does).  Autouse where a test module
    imports it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_EAGER = (ref_wop.programmable_bootstrap, ref_wop.keyswitch)


@functools.cache
def _jitted():
    return tuple(jax.jit(fn) for fn in _EAGER)


@contextlib.contextmanager
def jitted_reference():
    ref_wop.programmable_bootstrap, ref_wop.keyswitch = _jitted()
    try:
        yield
    finally:
        ref_wop.programmable_bootstrap, ref_wop.keyswitch = _EAGER


def words(x) -> np.ndarray:
    """u64 words of an int64 tensor or of a reference array."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy().view(np.uint64)
    return np.asarray(x).astype(np.uint64)


def keys(seed: int = SEED):
    """((ref cks, sks, WopbsKey), (port cks, sks, WopbsKey)) at
    WOPBS_PARAM_MESSAGE_2_CARRY_2_TEST, the port's on the CPU."""
    return (ref_shortint.gen_keys_wopbs(REF_P, seed=seed),
            shortint.gen_keys_wopbs(P, seed=seed, device="cpu"))


def assert_batches_equal(ref_batch, batch):
    np.testing.assert_array_equal(words(batch.data), words(ref_batch.data))
    np.testing.assert_array_equal(batch.degrees, ref_batch.degrees)
