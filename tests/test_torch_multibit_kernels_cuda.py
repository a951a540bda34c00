"""The port's multi-bit CUDA kernels against their plain versions, bit for
bit, on a card (tolerance 0): one group step of each at the two
tests/test_fused_multibit.py shapes and at the width of
PARAM_MULTI_BIT_MESSAGE_2_CARRY_2_GROUP_3_KS_PBS, a short blind rotation in
both schedules, and the two schedules against each other; K8's two stages
(the combine, and the external product from the accumulator on the
register-resident core) and K9's one-launch step on the core at gf = 2, 3
and 4, N = 256 ... 2048 and B = 1, 3, 64 and 256; each on the
reference's five primes in two planes and on the set the widths give
(`ntt.classic_plan` for 2^gf summed words: four wide primes and one plane
at GROUP_3); every sum at its extreme (every key word p - 1, every
monomial p - 1; 16 subsets at L*G = 18); the layouts beyond the kernels'
limits, refused.
Marked `cuda`: they skip where there is no card; on one, run
`python -m pytest -m cuda --noconftest tests/test_torch_multibit_kernels_cuda.py`
(tests/conftest.py imports JAX, which is not needed here)."""

import numpy as np
import pytest
import torch

from tfhe_tpu_torch.ops import fused_multibit as fm
from tfhe_tpu_torch.ops import ntt

pytestmark = pytest.mark.cuda

# (gf, N, L, base_log, B, groups): the tests/test_fused_multibit.py cases,
# then the GROUP_3 parameter set's width at the smoke's batch
CASES = [(2, 256, 2, 8, 4, 3), (3, 256, 1, 15, 4, 3), (3, 2048, 1, 21, 64, 2)]
IDS = ["gf2N256L2", "gf3N256L1", "gf3N2048L1B64"]
G = 2
# the key's prime set: the reference's five primes, or the plan's (None)
KEY_SETS = [ntt.PRIMES, None]
KEY_IDS = ["five", "plan"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def _words(rng, shape, dev):
    x = rng.integers(0, 2**64 - 1, shape, dtype=np.uint64, endpoint=True)
    return torch.from_numpy(x.view(np.int64)).to(dev)


def _inputs(case, dev, seed=7, primes=None):
    gf, N, L, bl, B, groups = case
    rng = np.random.default_rng(seed)
    key = fm.prepare_multi_bit_bsk_cuda(
        _words(rng, (groups, 1 << gf, L, G, G, N), dev), bl, gf, primes)
    acc = _words(rng, (B, G, N), dev)
    d = torch.from_numpy(rng.integers(0, 2 * N, (groups, B, 1 << gf))
                         .astype(np.int32)).to(dev)
    d[:, :, 0] = 0  # the empty subset's sum switches to 0
    return key, acc, d


@pytest.mark.parametrize("primes", KEY_SETS, ids=KEY_IDS)
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_kernels_match_plain(case, primes, card):
    gf, N, L, bl, B, groups = case
    key, acc, d = _inputs(case, card, primes=primes)
    ks, ps = key.kspec[0], key.primes
    comb = fm.multibit_combine(d[0], ks, primes=ps)
    assert torch.equal(comb, fm.multibit_combine_plain(d[0], ks, ps))
    want = fm.multibit_external_product_plain(acc, comb, bl, L, ps)
    assert torch.equal(fm.multibit_external_product(acc, comb, bl, L,
                                                    primes=ps), want)
    assert torch.equal(fm.multibit_step_plain(acc, d[0], ks, bl, L, ps),
                       want)
    assert torch.equal(fm.multibit_step(acc, d[0], ks, bl, L, primes=ps),
                       want)
    plain = acc
    for g in range(groups):
        plain = fm.multibit_external_product_plain(
            plain, fm.multibit_combine_plain(d[g], key.kspec[g], ps), bl, L,
            ps)
    for mode in fm.MODES:
        got = fm.multi_bit_blind_rotate_cuda(key, acc, d, mode=mode)
        torch.cuda.synchronize()
        assert torch.equal(got, plain), mode


def test_schedules_agree_and_count_their_launches(card):
    # scan3: combine, then the external product from the accumulator, a
    # group step; scan1: one launch a group step
    key, acc, d = _inputs(CASES[1], card, seed=3)
    assert (key.primes, key.planes) == (ntt.WIDE_PRIMES[:4], 1)
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


@pytest.mark.parametrize("primes", KEY_SETS, ids=KEY_IDS)
@pytest.mark.parametrize("B", [1, 3, 64, 256])
@pytest.mark.parametrize("width", STEP_WIDTHS, ids=STEP_IDS)
def test_step_on_the_core_matches_plain(width, B, primes, card):
    gf, N, L, bl, G = width
    rng = np.random.default_rng([29, B])
    key = fm.prepare_multi_bit_bsk_cuda(
        _words(rng, (1, 1 << gf, L, G, G, N), card), bl, gf, primes)
    acc = _words(rng, (B, G, N), card)
    d = torch.from_numpy(rng.integers(0, 2 * N, (B, 1 << gf))
                         .astype(np.int32)).to(card)
    ks, ps = key.kspec[0], key.primes
    fm.reset_launch_counts()
    got = fm.multibit_step(acc, d, ks, bl, L, primes=ps)
    torch.cuda.synchronize()
    assert [k.launches for k in fm.KERNELS] == [0, 0, 1]
    assert torch.equal(got, fm.multibit_step_plain(acc, d, ks, bl, L, ps))


@pytest.mark.parametrize("primes", KEY_SETS, ids=KEY_IDS)
@pytest.mark.parametrize("B", [1, 3, 64, 256])
@pytest.mark.parametrize("width", STEP_WIDTHS, ids=STEP_IDS)
def test_scan3_stages_match_plain(width, B, primes, card):
    # K8's two stages, each against its plain twin, one launch each
    gf, N, L, bl, G = width
    rng = np.random.default_rng([31, B])
    key = fm.prepare_multi_bit_bsk_cuda(
        _words(rng, (1, 1 << gf, L, G, G, N), card), bl, gf, primes)
    acc = _words(rng, (B, G, N), card)
    d = torch.from_numpy(rng.integers(0, 2 * N, (B, 1 << gf))
                         .astype(np.int32)).to(card)
    ks, ps = key.kspec[0], key.primes
    fm.reset_launch_counts()
    comb = fm.multibit_combine(d, ks, primes=ps)
    got = fm.multibit_external_product(acc, comb, bl, L, primes=ps)
    torch.cuda.synchronize()
    assert [k.launches for k in fm.KERNELS] == [1, 1, 0]
    comb_p = fm.multibit_combine_plain(d, ks, ps)
    assert torch.equal(comb, comb_p)
    assert torch.equal(got, fm.multibit_external_product_plain(acc, comb_p,
                                                               bl, L, ps))


def _full_key(primes, per, LJ, G, M, N, dev):
    """kspec [per, P, LJ, G, M, N]: every word p - 1."""
    p = torch.tensor(primes, dtype=torch.int64).view(1, -1, 1, 1, 1, 1)
    return (p - 1).expand(per, -1, LJ, G, M, N).to(torch.int32).contiguous(
        ).to(dev)


@pytest.mark.parametrize("primes", [ntt.PRIMES, ntt.WIDE_PRIMES[:4]],
                         ids=["five", "wide"])
def test_sums_at_their_extremes_match_plain(primes, card):
    # the combine: every key word p - 1 and every monomial p - 1 (d_j = N),
    # at GROUP_3's width (gf 3, N 2048, L*G 2); K8's external product on
    # those keys; K9 at 16 subsets and L*G = 18, 288 terms a sum, every key
    # word p - 1.  Bit for bit against the plain versions
    M = 2 if primes == ntt.PRIMES else 1
    rng = np.random.default_rng(41)
    N, B = 2048, 64
    ks = _full_key(primes, 8, 2, 2, M, N, card)
    d = torch.full((B, 8), N, dtype=torch.int32, device=card)
    d[1::2, 1:] = torch.from_numpy(rng.integers(0, 2 * N, (B // 2, 7))
                                   .astype(np.int32)).to(card)
    comb = fm.multibit_combine(d, ks, primes=primes)
    assert torch.equal(comb, fm.multibit_combine_plain(d, ks, primes))
    acc = _words(rng, (B, 2, N), card)
    assert torch.equal(
        fm.multibit_external_product(acc, comb, 21, 1, primes=primes),
        fm.multibit_external_product_plain(acc, comb, 21, 1, primes))
    L, bl, G3 = 6, 7, 3  # L*G = 18
    ks = _full_key(primes, 16, L * G3, G3, M, N, card)
    d = torch.from_numpy(rng.integers(0, 2 * N, (B, 16)).astype(np.int32)
                         ).to(card)
    acc = _words(rng, (B, G3, N), card)
    assert torch.equal(fm.multibit_step(acc, d, ks, bl, L, primes=primes),
                       fm.multibit_step_plain(acc, d, ks, bl, L, primes))


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
    ps = key.primes
    with pytest.raises(ValueError):
        fm.multibit_combine(d[0].long(), key.kspec[0], primes=ps)
    with pytest.raises(ValueError):
        fm.multibit_combine(d[0], key.kspec[0][:, :3], primes=ps[:3])
    comb = fm.multibit_combine(d[0], key.kspec[0], primes=ps)
    with pytest.raises(ValueError):
        fm.multibit_external_product(acc[:, :, ::2], comb, 15, 1, primes=ps)
    with pytest.raises(ValueError):  # levels 2: comb holds L*G = 2 rows
        fm.multibit_external_product(acc, comb, 15, 2, primes=ps)
    # a contiguous copy that starts 4 bytes into its buffer
    shifted = torch.empty(comb.numel() + 1, dtype=comb.dtype, device=card)
    shifted = shifted[1:].view(comb.shape)
    shifted.copy_(comb)
    with pytest.raises(ValueError, match="aligned"):
        fm.multibit_external_product(acc, shifted, 15, 1, primes=ps)
    with pytest.raises(ValueError):
        fm.multibit_step(acc, d[0][:, :4], key.kspec[0], 15, 1, primes=ps)
    with pytest.raises(ValueError, match="does not match"):  # another set
        fm.multibit_combine(d[0], key.kspec[0])
    with pytest.raises(ValueError):
        fm.multibit_step(acc[:, :, :128], d[0], key.kspec[0], 15, 1,
                         primes=ps)


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
