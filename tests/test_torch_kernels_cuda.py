"""The port's CUDA kernels against their plain versions, bit for bit, on a
card (tolerance 0): one step of each at the tests/test_fused_pbs.py cases
and at the width of PARAM_MESSAGE_2_CARRY_2_KS_PBS, a short blind rotation,
and a batch past the 65535 blocks of a grid's y dimension.  Marked `cuda`: they skip where there is no card; on one, run
`python -m pytest -m cuda --noconftest tests/test_torch_kernels_cuda.py`
(tests/conftest.py imports JAX, which is not needed here)."""

import numpy as np
import pytest
import torch

from tfhe_tpu_torch.ops import fused_pbs
from test_torch_cases import CASES, IDS

pytestmark = pytest.mark.cuda

# the tests/test_fused_pbs.py cases, then the width of
# PARAM_MESSAGE_2_CARRY_2_KS_PBS; n is the number of blind-rotation steps
FULL_WIDTH = dict(n=3, L=1, G=2, N=2048, B=64, bl=23, bits=64)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def _words(rng, shape, bits, dev):
    hi = 2**64 - 1 if bits == 64 else 2**32 - 1
    x = rng.integers(0, hi, shape, dtype=np.uint64, endpoint=True)
    return torch.from_numpy(x.view(np.int64)).to(dev)


@pytest.mark.parametrize("case", CASES + [FULL_WIDTH],
                         ids=IDS + ["n3L1G2N2048"])
def test_kernels_match_plain(case, card):
    rng = np.random.default_rng(7)
    steps, L, G, N, B, bl, bits = (case[k] for k in ("n", "L", "G", "N", "B",
                                                     "bl", "bits"))
    key = fused_pbs.prepare_bsk_cuda(_words(rng, (steps, L, G, G, N), bits,
                                            card), bl, bits)
    acc = _words(rng, (B, G, N), bits, card)
    ahat = torch.from_numpy(rng.integers(0, 2 * N, (steps, B), endpoint=True)
                            .astype(np.int32)).to(card)
    dig = fused_pbs.rotate_decompose(acc, ahat[0], bl, L, bits)
    assert torch.equal(dig, fused_pbs.rotate_decompose_plain(acc, ahat[0], bl,
                                                             L, bits))
    out = fused_pbs.external_product_crt(dig, key.kspec[0], key.kshoup[0], acc,
                                         bits)
    assert torch.equal(out, fused_pbs.external_product_crt_plain(
        dig, key.kspec[0], acc, bits))
    got = fused_pbs.blind_rotate_fused(key, acc, ahat)
    want = acc
    for i in range(steps):
        d = fused_pbs.rotate_decompose_plain(want, ahat[i], bl, L, bits)
        want = fused_pbs.external_product_crt_plain(d, key.kspec[i], want, bits)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_batch_beyond_a_grid_dimension_of_65535(card):
    # K2's kernel puts the batch on grid.x: B past 65535 (grid.y's limit)
    # launches, and each ciphertext's result is its own
    rng = np.random.default_rng(11)
    L, G, N, B, bl = 1, 2, 256, 65536 + 8, 23
    key = fused_pbs.prepare_bsk_cuda(_words(rng, (1, L, G, G, N), 64, card),
                                     bl)
    acc = _words(rng, (B, G, N), 64, card)
    ahat = torch.from_numpy(rng.integers(0, 2 * N, (B,)).astype(np.int32)
                            ).to(card)
    dig = fused_pbs.rotate_decompose(acc, ahat, bl, L)
    out = fused_pbs.external_product_crt(dig, key.kspec[0], key.kshoup[0], acc)
    rows = torch.cat([torch.arange(8), torch.arange(B - 16, B)]).to(card)
    want = fused_pbs.external_product_crt_plain(
        fused_pbs.rotate_decompose_plain(acc[rows], ahat[rows], bl, L),
        key.kspec[0], acc[rows])
    torch.cuda.synchronize()
    assert torch.equal(out[rows], want)


def test_empty_batch_launches_nothing(card):
    key = fused_pbs.prepare_bsk_cuda(
        torch.zeros((1, 1, 2, 2, 256), dtype=torch.int64, device=card), 23)
    acc = torch.zeros((0, 2, 256), dtype=torch.int64, device=card)
    ahat = torch.zeros((1, 0), dtype=torch.int32, device=card)
    fused_pbs.reset_launch_counts()
    out = fused_pbs.blind_rotate_fused(key, acc, ahat)
    torch.cuda.synchronize()
    assert out.shape == (0, 2, 256)
    assert [k.launches for k in fused_pbs.KERNELS] == [0] * len(
        fused_pbs.KERNELS)


def test_wrappers_reject_bad_inputs(card):
    acc = torch.zeros((2, 2, 256), dtype=torch.int64, device=card)
    ahat = torch.zeros((2,), dtype=torch.int64, device=card)
    with pytest.raises(ValueError):
        fused_pbs.rotate_decompose(acc, ahat, 23, 1)
    with pytest.raises(ValueError):
        fused_pbs.rotate_decompose(acc[:, :, ::2], ahat.int(), 23, 1)
