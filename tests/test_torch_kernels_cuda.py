"""The port's CUDA kernels against their plain versions, bit for bit, on a
card (tolerance 0): one step of each at the tests/test_fused_pbs.py cases
and at the width of PARAM_MESSAGE_2_CARRY_2_KS_PBS, a short blind rotation,
and a batch past the 65535 blocks of a grid's y dimension; K2 on the
register-resident NTT core at every width the port runs (both full widths,
the PBS_KS set's base_log 21, the TEST sets, the sets at N = 1024 and the
cases) and at batch
sizes around one and two waves of the card's 132 SMs; K1 at every such
width and batch, with a = 0, 2N (the identity) and random rotations.
Marked `cuda`: they skip where there is no card; on one, run
`python -m pytest -m cuda --noconftest tests/test_torch_kernels_cuda.py`
(tests/conftest.py imports JAX, which is not needed here)."""

import numpy as np
import pytest
import torch

from tfhe_tpu_torch.ops import fused_pbs, ntt
from test_torch_cases import CASES, IDS

pytestmark = pytest.mark.cuda

# the tests/test_fused_pbs.py cases, then the width of
# PARAM_MESSAGE_2_CARRY_2_KS_PBS; n is the number of blind-rotation steps
FULL_WIDTH = dict(n=3, L=1, G=2, N=2048, B=64, bl=23, bits=64)

# K2's widths: PARAM_MESSAGE_2_CARRY_2_KS_PBS, boolean DEFAULT_PARAMETERS,
# PARAM_MESSAGE_2_CARRY_2_COMPACT_PK_PBS_KS (base_log 21),
# PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST, BOOLEAN_TEST_PARAMETERS; the sets
# at N = 1024, the one size whose pass plan has a first pass of one stage
# (PARAM_MESSAGE_2_CARRY_1_KS_PBS, boolean
# PARAMETERS_ERROR_PROB_2_POW_MINUS_165, its _KS_PBS variant and
# TFHE_LIB_PARAMETERS); then the cases (their B is replaced by each of
# BATCHES)
WIDTHS = [dict(L=1, G=2, N=2048, bl=23, bits=64),
          dict(L=3, G=3, N=512, bl=6, bits=32),
          dict(L=1, G=2, N=2048, bl=21, bits=64),
          dict(L=1, G=2, N=256, bl=23, bits=64),
          dict(L=3, G=3, N=256, bl=6, bits=32),
          dict(L=1, G=3, N=1024, bl=23, bits=64),
          dict(L=2, G=3, N=1024, bl=10, bits=32),
          dict(L=4, G=2, N=1024, bl=5, bits=32),
          dict(L=3, G=2, N=1024, bl=7, bits=32)] + [
    {k: c[k] for k in ("L", "G", "N", "bl", "bits")} for c in CASES]
WIDTH_IDS = ["shortint", "boolean", "pbs_ks", "shortint_test",
             "boolean_test", "shortint_n1024", "boolean_165",
             "boolean_165_ks_pbs", "boolean_tfhe_lib"] + IDS
BATCHES = [1, 8, 63, 64, 65, 132, 133, 256, 512]


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
    ps = {"primes": key.primes}
    out = fused_pbs.external_product_crt(dig, key.kspec[0], key.kshoup[0], acc,
                                         bits, **ps)
    assert torch.equal(out, fused_pbs.external_product_crt_plain(
        dig, key.kspec[0], acc, bits, **ps))
    got = fused_pbs.blind_rotate_fused(key, acc, ahat)
    want = acc
    for i in range(steps):
        d = fused_pbs.rotate_decompose_plain(want, ahat[i], bl, L, bits)
        want = fused_pbs.external_product_crt_plain(d, key.kspec[i], want, bits,
                                                    **ps)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("width", WIDTHS, ids=WIDTH_IDS)
def test_external_product_on_the_core_matches_plain(width, B, card):
    rng = np.random.default_rng([29, B])
    L, G, N, bl, bits = (width[k] for k in ("L", "G", "N", "bl", "bits"))
    key = fused_pbs.prepare_bsk_cuda(_words(rng, (1, L, G, G, N), bits,
                                            card), bl, bits)
    acc = _words(rng, (B, G, N), bits, card)
    ahat = torch.from_numpy(rng.integers(0, 2 * N, (B,), endpoint=True)
                            .astype(np.int32)).to(card)
    dig = fused_pbs.rotate_decompose_plain(acc, ahat, bl, L, bits)
    fused_pbs.reset_launch_counts()
    out = fused_pbs.external_product_crt(dig, key.kspec[0], key.kshoup[0], acc,
                                         bits, primes=key.primes)
    torch.cuda.synchronize()
    assert fused_pbs.external_product_crt.launches == 1
    assert torch.equal(out, fused_pbs.external_product_crt_plain(
        dig, key.kspec[0], acc, bits, primes=key.primes))


@pytest.mark.parametrize("B", [1, 8, 64, 512])
@pytest.mark.parametrize("width", WIDTHS[:2], ids=WIDTH_IDS[:2])
def test_every_prime_set_gives_the_same_words(width, B, card):
    # the classic key's set (four primes and one plane at the shortint
    # width, two primes at boolean width) and the reference's five primes
    # (two planes of a u64 word): K2 and every mode's blind rotation equal
    # their plain versions and each other, word for word
    rng = np.random.default_rng([31, B])
    L, G, N, bl, bits = (width[k] for k in ("L", "G", "N", "bl", "bits"))
    raw = _words(rng, (2, L, G, G, N), bits, card)
    keys = [fused_pbs.prepare_bsk_cuda(raw, bl, bits),
            fused_pbs.prepare_bsk_cuda(raw, bl, bits,
                                       primes=ntt.PRIMES)]
    assert len(keys[0].primes) == (4 if bits == 64 else 2)
    assert (keys[0].planes, keys[1].planes) == (1, 2 if bits == 64 else 1)
    acc = _words(rng, (B, G, N), bits, card)
    ahat = torch.from_numpy(rng.integers(0, 2 * N, (2, B), endpoint=True)
                            .astype(np.int32)).to(card)
    dig = fused_pbs.rotate_decompose(acc, ahat[0], bl, L, bits)
    words = []
    for key in keys:
        out = fused_pbs.external_product_crt(dig, key.kspec[0], key.kshoup[0],
                                             acc, bits, primes=key.primes)
        assert torch.equal(out, fused_pbs.external_product_crt_plain(
            dig, key.kspec[0], acc, bits, primes=key.primes))
        words.append(out)
        rots = [fused_pbs.blind_rotate_fused(key, acc, ahat, mode)
                for mode in fused_pbs.MODES]
        torch.cuda.synchronize()
        assert all(torch.equal(r, rots[0]) for r in rots)
        words.append(rots[0])
    assert torch.equal(words[0], words[2]) and torch.equal(words[1], words[3])


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("width", WIDTHS, ids=WIDTH_IDS)
def test_rotate_decompose_matches_plain(width, B, card):
    # K1, one launch, with the edge rotations a = 0 and a = 2N (both the
    # identity) among random ones, each past the wrap at N or 2N
    rng = np.random.default_rng([37, B])
    L, G, N, bl, bits = (width[k] for k in ("L", "G", "N", "bl", "bits"))
    acc = _words(rng, (B, G, N), bits, card)
    ahat = rng.integers(0, 2 * N, (B,), endpoint=True)
    ahat[:2] = (0, 2 * N)[:B]
    ahat = torch.from_numpy(ahat.astype(np.int32)).to(card)
    fused_pbs.reset_launch_counts()
    got = fused_pbs.rotate_decompose(acc, ahat, bl, L, bits)
    torch.cuda.synchronize()
    assert fused_pbs.rotate_decompose.launches == 1
    assert torch.equal(got, fused_pbs.rotate_decompose_plain(acc, ahat, bl, L,
                                                             bits))


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
    out = fused_pbs.external_product_crt(dig, key.kspec[0], key.kshoup[0], acc,
                                         primes=key.primes)
    rows = torch.cat([torch.arange(8), torch.arange(B - 16, B)]).to(card)
    want = fused_pbs.external_product_crt_plain(
        fused_pbs.rotate_decompose_plain(acc[rows], ahat[rows], bl, L),
        key.kspec[0], acc[rows], primes=key.primes)
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
    # K1 reads 16 bytes at a time: a contiguous accumulator that starts 8
    # bytes into its buffer is refused
    shifted = torch.zeros(acc.numel() + 1, dtype=torch.int64,
                          device=card)[1:].view(acc.shape)
    with pytest.raises(ValueError, match="aligned"):
        fused_pbs.rotate_decompose(shifted, ahat.int(), 23, 1)
    # the core's limits: L*G <= 18 (the launch is refused, naming the
    # limit) and 256 <= N <= 2048 (no tables)
    for L, G, N, error, match in ((10, 2, 256, RuntimeError,
                                   "InvalidValue.*at most 18 digit"),
                                  (1, 2, 128, ValueError, "NTT core")):
        key = fused_pbs.prepare_bsk_cuda(
            torch.zeros((1, L, G, G, N), dtype=torch.int64, device=card), 8)
        dig = torch.zeros((1, L, G, N), dtype=torch.int32, device=card)
        with pytest.raises(error, match=match):
            fused_pbs.external_product_crt(
                dig, key.kspec[0], key.kshoup[0],
                torch.zeros((1, G, N), dtype=torch.int64, device=card),
                primes=key.primes)
