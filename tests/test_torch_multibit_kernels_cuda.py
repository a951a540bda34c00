"""The port's multi-bit CUDA kernels against their plain versions, bit for
bit, on a card (tolerance 0): one group step of each at the two
tests/test_fused_multibit.py shapes and at the width of
PARAM_MULTI_BIT_MESSAGE_2_CARRY_2_GROUP_3_KS_PBS, a short blind rotation in
both schedules, and the two schedules against each other.  Marked `cuda`:
they skip where there is no card; on one, run
`python -m pytest -m cuda --noconftest tests/test_torch_multibit_kernels_cuda.py`
(tests/conftest.py imports JAX, which is not needed here)."""

import numpy as np
import pytest
import torch

from tfhe_tpu_torch.ops import fused_multibit as fm

pytestmark = pytest.mark.cuda

# (gf, N, L, base_log, B, groups): the tests/test_fused_multibit.py cases,
# then the GROUP_3 parameter set's width at the smoke's batch
CASES = [(2, 256, 2, 8, 4, 3), (3, 256, 1, 15, 4, 3), (3, 2048, 1, 21, 64, 2)]
IDS = ["gf2N256L2", "gf3N256L1", "gf3N2048L1B64"]
G = 2


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def _words(rng, shape, dev):
    x = rng.integers(0, 2**64 - 1, shape, dtype=np.uint64, endpoint=True)
    return torch.from_numpy(x.view(np.int64)).to(dev)


def _inputs(case, dev, seed=7):
    gf, N, L, bl, B, groups = case
    rng = np.random.default_rng(seed)
    key = fm.prepare_multi_bit_bsk_cuda(
        _words(rng, (groups, 1 << gf, L, G, G, N), dev), bl, gf)
    acc = _words(rng, (B, G, N), dev)
    d = torch.from_numpy(rng.integers(0, 2 * N, (groups, B, 1 << gf))
                         .astype(np.int32)).to(dev)
    d[:, :, 0] = 0  # the empty subset's sum switches to 0
    return key, acc, d


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_kernels_match_plain(case, card):
    gf, N, L, bl, B, groups = case
    key, acc, d = _inputs(case, card)
    dig = fm.decompose(acc, bl, L)
    assert torch.equal(dig, fm.decompose_plain(acc, bl, L))
    comb = fm.multibit_combine(d[0], key.kspec[0])
    assert torch.equal(comb, fm.multibit_combine_plain(d[0], key.kspec[0]))
    want = fm.multibit_external_product_plain(dig, comb)
    assert torch.equal(fm.multibit_external_product(dig, comb), want)
    assert torch.equal(fm.multibit_step(dig, d[0], key.kspec[0],
                                        key.kshoup[0]), want)
    plain = acc
    for g in range(groups):
        plain = fm.multibit_external_product_plain(
            fm.decompose_plain(plain, bl, L),
            fm.multibit_combine_plain(d[g], key.kspec[g]))
    for mode in fm.MODES:
        got = fm.multi_bit_blind_rotate_cuda(key, acc, d, mode=mode)
        torch.cuda.synchronize()
        assert torch.equal(got, plain), mode


def test_schedules_agree_and_count_their_launches(card):
    key, acc, d = _inputs(CASES[1], card, seed=3)
    fm.reset_launch_counts()
    scan3 = fm.multi_bit_blind_rotate_cuda(key, acc, d, mode="scan3")
    scan1 = fm.multi_bit_blind_rotate_cuda(key, acc, d, mode="scan1")
    torch.cuda.synchronize()
    assert torch.equal(scan3, scan1)
    assert [k.launches for k in fm.KERNELS] == [6, 3, 3, 3]


def test_empty_batch_launches_nothing(card):
    key, acc, d = _inputs(CASES[1], card)
    fm.reset_launch_counts()
    out = fm.multi_bit_blind_rotate_cuda(key, acc[:0], d[:, :0])
    torch.cuda.synchronize()
    assert out.shape == (0, G, 256)
    assert [k.launches for k in fm.KERNELS] == [0, 0, 0, 0]


def test_wrappers_reject_bad_inputs(card):
    key, acc, d = _inputs(CASES[1], card)
    with pytest.raises(ValueError):
        fm.multibit_combine(d[0].long(), key.kspec[0])
    with pytest.raises(ValueError):
        fm.multibit_combine(d[0], key.kspec[0][:, :3])
    with pytest.raises(ValueError):
        fm.decompose(acc[:, :, ::2], 15, 1)
    dig = fm.decompose(acc, 15, 1)
    with pytest.raises(ValueError):
        fm.multibit_step(dig, d[0][:, :4], key.kspec[0], key.kshoup[0])


def test_kernels_reject_layouts_beyond_their_limits(card):
    """The C entry points, not the wrappers, hold the kernels' limits:
    2^gf <= 16 subsets, O*M <= 8 outputs, the device's shared memory."""
    gen = torch.Generator(device=card).manual_seed(1)

    def words(*shape):
        return torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                             dtype=torch.int32, device=card)

    def digits(L, G, N):
        return torch.zeros((1, L, G, N), dtype=torch.int32, device=card)

    fm.reset_launch_counts()
    d32 = torch.zeros((1, 32), dtype=torch.int32, device=card)
    with pytest.raises(RuntimeError, match="InvalidValue"):  # 32 subsets
        fm.multibit_combine(d32, words(32, 5, 2, 2, 2, 256))
    wide = words(2, 5, 5, 5, 2, 256)  # G = 5: O*M = 10 outputs
    with pytest.raises(RuntimeError, match="InvalidValue"):
        fm.multibit_step(digits(1, 5, 256), words(1, 2), wide, wide)
    deep = words(2, 5, 40, 2, 2, 2048)  # L = 20: 44 spectra > 227 KiB
    with pytest.raises(RuntimeError, match="InvalidValue"):
        fm.multibit_step(digits(20, 2, 2048), words(1, 2) & 1, deep, deep)
    torch.cuda.synchronize()
    assert [k.launches for k in fm.KERNELS] == [0, 0, 0, 0]
