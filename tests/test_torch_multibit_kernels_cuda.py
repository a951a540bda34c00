"""The port's multi-bit CUDA kernels against their plain versions, bit for
bit, on a card (tolerance 0): one group step of each at the two
tests/test_fused_multibit.py shapes and at the width of
PARAM_MULTI_BIT_MESSAGE_2_CARRY_2_GROUP_3_KS_PBS, a short blind rotation in
both schedules, and the two schedules against each other; K8's two stages
(the combine, and the external product from the accumulator on the
register-resident core) and K9's one-launch step on the core at gf = 2, 3
and 4, N = 256 ... 2048 and B = 1, 3, 64 and 256; the layouts beyond the
kernels' limits, refused.
Marked `cuda`: they skip where there is no card; on one, run
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
    comb = fm.multibit_combine(d[0], key.kspec[0])
    assert torch.equal(comb, fm.multibit_combine_plain(d[0], key.kspec[0]))
    want = fm.multibit_external_product_plain(acc, comb, bl, L)
    assert torch.equal(fm.multibit_external_product(acc, comb, bl, L), want)
    assert torch.equal(fm.multibit_step_plain(acc, d[0], key.kspec[0], bl, L),
                       want)
    assert torch.equal(fm.multibit_step(acc, d[0], key.kspec[0], bl, L), want)
    plain = acc
    for g in range(groups):
        plain = fm.multibit_external_product_plain(
            plain, fm.multibit_combine_plain(d[g], key.kspec[g]), bl, L)
    for mode in fm.MODES:
        got = fm.multi_bit_blind_rotate_cuda(key, acc, d, mode=mode)
        torch.cuda.synchronize()
        assert torch.equal(got, plain), mode


def test_schedules_agree_and_count_their_launches(card):
    # scan3: combine, then the external product from the accumulator, a
    # group step; scan1: one launch a group step
    key, acc, d = _inputs(CASES[1], card, seed=3)
    fm.reset_launch_counts()
    scan3 = fm.multi_bit_blind_rotate_cuda(key, acc, d, mode="scan3")
    assert [k.launches for k in fm.KERNELS] == [3, 3, 0]
    fm.reset_launch_counts()
    scan1 = fm.multi_bit_blind_rotate_cuda(key, acc, d, mode="scan1")
    torch.cuda.synchronize()
    assert torch.equal(scan3, scan1)
    assert [k.launches for k in fm.KERNELS] == [0, 0, 3]


# K9 on the core: (gf, N, L, base_log, G) at every N the core takes, the
# sets' G = 4 width (O*M = 8 outputs), and L*G = 12 and 18 (the core's
# 18-digit variant)
STEP_WIDTHS = [(2, 256, 2, 8, 2), (3, 512, 1, 18, 4), (4, 1024, 1, 21, 2),
               (3, 2048, 1, 21, 2), (2, 2048, 1, 22, 2), (4, 2048, 1, 21, 2),
               (2, 1024, 6, 7, 2), (4, 2048, 6, 7, 3)]
STEP_IDS = ["gf2N256L2", "gf3N512G4", "gf4N1024", "gf3N2048", "gf2N2048",
            "gf4N2048", "gf2N1024LG12", "gf4N2048LG18"]


@pytest.mark.parametrize("B", [1, 3, 64, 256])
@pytest.mark.parametrize("width", STEP_WIDTHS, ids=STEP_IDS)
def test_step_on_the_core_matches_plain(width, B, card):
    gf, N, L, bl, G = width
    rng = np.random.default_rng([29, B])
    key = fm.prepare_multi_bit_bsk_cuda(
        _words(rng, (1, 1 << gf, L, G, G, N), card), bl, gf)
    acc = _words(rng, (B, G, N), card)
    d = torch.from_numpy(rng.integers(0, 2 * N, (B, 1 << gf))
                         .astype(np.int32)).to(card)
    fm.reset_launch_counts()
    got = fm.multibit_step(acc, d, key.kspec[0], bl, L)
    torch.cuda.synchronize()
    assert [k.launches for k in fm.KERNELS] == [0, 0, 1]
    assert torch.equal(got, fm.multibit_step_plain(acc, d, key.kspec[0], bl,
                                                   L))


@pytest.mark.parametrize("B", [1, 3, 64, 256])
@pytest.mark.parametrize("width", STEP_WIDTHS, ids=STEP_IDS)
def test_scan3_stages_match_plain(width, B, card):
    # K8's two stages, each against its plain twin, one launch each
    gf, N, L, bl, G = width
    rng = np.random.default_rng([31, B])
    key = fm.prepare_multi_bit_bsk_cuda(
        _words(rng, (1, 1 << gf, L, G, G, N), card), bl, gf)
    acc = _words(rng, (B, G, N), card)
    d = torch.from_numpy(rng.integers(0, 2 * N, (B, 1 << gf))
                         .astype(np.int32)).to(card)
    fm.reset_launch_counts()
    comb = fm.multibit_combine(d, key.kspec[0])
    got = fm.multibit_external_product(acc, comb, bl, L)
    torch.cuda.synchronize()
    assert [k.launches for k in fm.KERNELS] == [1, 1, 0]
    comb_p = fm.multibit_combine_plain(d, key.kspec[0])
    assert torch.equal(comb, comb_p)
    assert torch.equal(got, fm.multibit_external_product_plain(acc, comb_p,
                                                               bl, L))


def test_empty_batch_launches_nothing(card):
    key, acc, d = _inputs(CASES[1], card)
    fm.reset_launch_counts()
    for mode in fm.MODES:
        out = fm.multi_bit_blind_rotate_cuda(key, acc[:0], d[:, :0], mode)
        assert out.shape == (0, G, 256)
    torch.cuda.synchronize()
    assert [k.launches for k in fm.KERNELS] == [0, 0, 0]


def test_wrappers_reject_bad_inputs(card):
    key, acc, d = _inputs(CASES[1], card)
    with pytest.raises(ValueError):
        fm.multibit_combine(d[0].long(), key.kspec[0])
    with pytest.raises(ValueError):
        fm.multibit_combine(d[0], key.kspec[0][:, :3])
    comb = fm.multibit_combine(d[0], key.kspec[0])
    with pytest.raises(ValueError):
        fm.multibit_external_product(acc[:, :, ::2], comb, 15, 1)
    with pytest.raises(ValueError):  # levels 2: comb holds L*G = 2 rows
        fm.multibit_external_product(acc, comb, 15, 2)
    # a contiguous copy that starts 4 bytes into its buffer
    shifted = torch.empty(comb.numel() + 1, dtype=comb.dtype, device=card)
    shifted = shifted[1:].view(comb.shape)
    shifted.copy_(comb)
    with pytest.raises(ValueError, match="aligned"):
        fm.multibit_external_product(acc, shifted, 15, 1)
    with pytest.raises(ValueError):
        fm.multibit_step(acc, d[0][:, :4], key.kspec[0], 15, 1)
    with pytest.raises(ValueError):
        fm.multibit_step(acc[:, :, :128], d[0], key.kspec[0], 15, 1)


def test_kernels_reject_layouts_beyond_their_limits(card):
    """The C entry points, not the wrappers, hold the kernels' limits:
    2^gf <= 16 subsets, O*M <= 8 outputs; and those of K8's external
    product and K9 on the core: L*G <= 18 digit polynomials and 256 <= N <=
    2048 (N by the core's tables, in Python)."""
    gen = torch.Generator(device=card).manual_seed(1)

    def words(*shape):
        return torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                             dtype=torch.int32, device=card)

    def acc(G, N):
        return torch.zeros((1, G, N), dtype=torch.int64, device=card)

    fm.reset_launch_counts()
    d32 = torch.zeros((1, 32), dtype=torch.int32, device=card)
    with pytest.raises(RuntimeError, match="InvalidValue"):  # 32 subsets
        fm.multibit_combine(d32, words(32, 5, 2, 2, 2, 256))
    # K9: gf = 5, 32 subsets
    with pytest.raises(RuntimeError, match="InvalidValue"):
        fm.multibit_step(acc(2, 256), d32, words(32, 5, 2, 2, 2, 256), 15, 1)
    wide = words(2, 5, 5, 5, 2, 256)  # G = 5: O*M = 10 outputs
    with pytest.raises(RuntimeError, match="InvalidValue"):
        fm.multibit_step(acc(5, 256), words(1, 2) & 1, wide, 15, 1)
    # L*G = 20 digit polynomials, past the core's 18
    with pytest.raises(RuntimeError, match="InvalidValue.*at most 18 digit"):
        fm.multibit_step(acc(2, 256), words(1, 2) & 1,
                         words(2, 5, 20, 2, 2, 256), 6, 10)
    deep = words(2, 5, 40, 2, 2, 2048)  # L = 20: 40 digit polynomials
    with pytest.raises(RuntimeError, match="InvalidValue"):
        fm.multibit_step(acc(2, 2048), words(1, 2) & 1, deep, 3, 20)
    with pytest.raises(ValueError):  # N = 4096, past the core's 2048
        fm.multibit_step(acc(2, 4096), words(1, 2) & 1,
                         words(2, 5, 2, 2, 2, 4096), 21, 1)
    # K8's external product: O*M = 10 outputs, L*G = 20, N = 4096
    with pytest.raises(RuntimeError, match="InvalidValue"):
        fm.multibit_external_product(acc(5, 256), words(1, 5, 5, 5, 2, 256),
                                     15, 1)
    with pytest.raises(RuntimeError, match="InvalidValue"):
        fm.multibit_external_product(acc(2, 256), words(1, 5, 20, 2, 2, 256),
                                     6, 10)
    with pytest.raises(ValueError):
        fm.multibit_external_product(acc(2, 4096),
                                     words(1, 5, 2, 2, 2, 4096), 21, 1)
    torch.cuda.synchronize()
    assert [k.launches for k in fm.KERNELS] == [0, 0, 0]
