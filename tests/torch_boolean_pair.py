"""Helpers for the tests of the boolean examples (tests/test_torch_examples
_sha*.py, test_torch_trivium.py): both packages' boolean keys from one seed,
and word-for-word comparison of their gate outputs (the reference's uint32
arrays against the port's int64 tensors of u32 words, tolerance 0)."""

import numpy as np
import pytest
import torch

from tfhe_tpu import boolean as ref_boolean
from tfhe_tpu.params import BOOLEAN_SHA_TEST_PARAMETERS as REF_P

from tfhe_tpu_torch import boolean
from tfhe_tpu_torch.ops.torus import to_numpy
from tfhe_tpu_torch.params import BOOLEAN_SHA_TEST_PARAMETERS as P


def boolean_keys(seed):
    """(reference (cks, sks), port (cks, sks)) at
    BOOLEAN_SHA_TEST_PARAMETERS, the port's on the CPU."""
    return (ref_boolean.gen_keys(REF_P, seed=seed),
            boolean.gen_keys(P, seed=seed, device="cpu"))


def same_words(ref_ct, port_ct):
    assert isinstance(port_ct, torch.Tensor)
    assert np.array_equal(np.asarray(ref_ct), to_numpy(port_ct, 32))


@pytest.fixture(scope="module")
def torch_threads(request):
    """The plain versions' many small ops on `threads` torch threads (one
    unless the module sets TORCH_THREADS)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(getattr(request.module, "TORCH_THREADS", 1))
    yield
    torch.set_num_threads(threads)
