"""The kernels of the classic schedules "scan1" (K3 `pbs_step`, on the card
K4's kernel), "scan1w" (K4 `pbs_step_single_cta`), "grid" (K5
`blind_rotate_persistent`), "mega"
(K7 `blind_rotate_single_cta`) and "scan3" (K6 `ntt_mac_prime`,
`crt_accumulate`) against their plain versions, bit for bit, on a card
(tolerance 0): at the tests/test_fused_pbs.py cases and at the widths of
PARAM_MESSAGE_2_CARRY_2_KS_PBS and of boolean DEFAULT_PARAMETERS; a blind
rotation in every mode, equal across modes, with its launch counts; the
empty batch; a batch past 65535 ciphertexts in one persistent launch and in
one single-CTA launch; K6's `crt_accumulate` at N = 256 ... 2048, both
torus widths, B = 1, 3, 64 and 256, on residues of integers at the
extremes of its range; K3 and K4, K5, K6's `ntt_mac_prime` and K7 on the
register-resident NTT core at every width the port runs (the sets at
N = 1024 among them), at batch sizes around one and two waves of the
card's 132 SMs, and K5 and K7 at the main paths' depth (742 and 722
steps); and the layouts beyond the kernels' limits, refused.
Marked `cuda`: they skip where there is no card; on one, run
`python -m pytest -m cuda --noconftest tests/test_torch_modes_kernels_cuda.py`
(tests/conftest.py imports JAX, which is not needed here)."""

import numpy as np
import pytest
import torch

from tfhe_tpu_torch.ops import fused_pbs, ntt
from test_torch_cases import CASES, IDS

pytestmark = pytest.mark.cuda

# n is the number of blind-rotation steps
WIDTHS = [dict(n=3, L=1, G=2, N=2048, B=64, bl=23, bits=64),
          dict(n=3, L=3, G=3, N=512, B=64, bl=6, bits=32)]
WIDTH_IDS = ["n3L1G2N2048", "n3L3G3N512u32"]
P = len(ntt.PRIMES)
# K7's widths: PARAM_MESSAGE_2_CARRY_2_KS_PBS, boolean DEFAULT_PARAMETERS,
# PARAM_MESSAGE_2_CARRY_2_COMPACT_PK_PBS_KS (base_log 21),
# PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST, BOOLEAN_TEST_PARAMETERS; the sets
# at N = 1024, the one size whose pass plan has a first pass of one stage
# (PARAM_MESSAGE_2_CARRY_1_KS_PBS, boolean
# PARAMETERS_ERROR_PROB_2_POW_MINUS_165, its _KS_PBS variant and
# TFHE_LIB_PARAMETERS); then the cases (their n and B replaced)
CORE_WIDTHS = [dict(L=1, G=2, N=2048, bl=23, bits=64),
               dict(L=3, G=3, N=512, bl=6, bits=32),
               dict(L=1, G=2, N=2048, bl=21, bits=64),
               dict(L=1, G=2, N=256, bl=23, bits=64),
               dict(L=3, G=3, N=256, bl=6, bits=32),
               dict(L=1, G=3, N=1024, bl=23, bits=64),
               dict(L=2, G=3, N=1024, bl=10, bits=32),
               dict(L=4, G=2, N=1024, bl=5, bits=32),
               dict(L=3, G=2, N=1024, bl=7, bits=32)] + [
    {k: c[k] for k in ("L", "G", "N", "bl", "bits")} for c in CASES]
CORE_WIDTH_IDS = ["shortint", "boolean", "pbs_ks", "shortint_test",
                  "boolean_test", "shortint_n1024", "boolean_165",
                  "boolean_165_ks_pbs", "boolean_tfhe_lib"] + IDS
BATCHES = [1, 63, 64, 65, 132, 133, 256]


def launched():
    return {fn.__name__: fn.launches for fn in fused_pbs.KERNELS
            if fn.launches}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def _inputs(rng, case, dev):
    steps, L, G, N, B, bl, bits = (case[k] for k in ("n", "L", "G", "N", "B",
                                                     "bl", "bits"))
    hi = 2**64 - 1 if bits == 64 else 2**32 - 1

    def words(*shape):
        x = rng.integers(0, hi, shape, dtype=np.uint64, endpoint=True)
        return torch.from_numpy(x.view(np.int64)).to(dev)

    key = fused_pbs.prepare_bsk_cuda(words(steps, L, G, G, N), bl, bits)
    ahat = torch.from_numpy(rng.integers(0, 2 * N, (steps, B), endpoint=True)
                            .astype(np.int32)).to(dev)
    ahat[0, 0] = 2 * N
    return key, words(B, G, N), ahat


@pytest.mark.parametrize("case", CASES + WIDTHS, ids=IDS + WIDTH_IDS)
def test_kernels_match_plain(case, card):
    rng = np.random.default_rng(13)
    key, acc, ahat = _inputs(rng, case, card)
    bl, L, bits = key.base_log, key.levels, key.bits
    B, G, N = acc.shape
    M = 2 if bits == 64 else 1
    dig = fused_pbs.rotate_decompose_plain(acc, ahat[0], bl, L, bits)
    res = torch.empty((B, G, M, P, N), dtype=torch.int32, device=card)
    res_p = torch.empty_like(res)
    for pi in range(P):
        fused_pbs.ntt_mac_prime(dig, key.kspec[0, pi], key.kshoup[0, pi], pi,
                                res)
        fused_pbs.ntt_mac_prime_plain(dig, key.kspec[0, pi], pi, res_p)
    torch.cuda.synchronize()
    assert torch.equal(res, res_p)
    assert torch.equal(fused_pbs.crt_accumulate(res_p, acc, bits),
                       fused_pbs.crt_accumulate_plain(res_p, acc, bits))
    step = fused_pbs.pbs_step(acc, ahat[0], key.kspec[0], key.kshoup[0], bl,
                              L, bits)
    assert torch.equal(step, fused_pbs.pbs_step_plain(acc, ahat[0],
                                                      key.kspec[0], bl, L,
                                                      bits))
    step_w = fused_pbs.pbs_step_single_cta(acc, ahat[0], key.kspec[0],
                                           key.kshoup[0], bl, L, bits)
    torch.cuda.synchronize()
    assert torch.equal(step_w, fused_pbs.pbs_step_plain(
        acc, ahat[0], key.kspec[0], bl, L, bits))
    want = fused_pbs.blind_rotate_persistent_plain(acc, ahat, key.kspec, bl,
                                                   L, bits)
    rot = fused_pbs.blind_rotate_persistent(acc, ahat, key.kspec, key.kshoup,
                                            bl, L, bits)
    torch.cuda.synchronize()
    assert torch.equal(rot, want)
    rot_single = fused_pbs.blind_rotate_single_cta(acc, ahat, key.kspec,
                                                   key.kshoup, bl, L, bits)
    torch.cuda.synchronize()
    assert torch.equal(rot_single, want)


@pytest.mark.parametrize("case", [CASES[2]] + WIDTHS,
                         ids=[IDS[2]] + WIDTH_IDS)
def test_every_mode_gives_the_same_rotation_with_its_launches(case, card):
    rng = np.random.default_rng(17)
    key, acc, ahat = _inputs(rng, case, card)
    n = key.input_dim
    want = {"scan2": dict(rotate_decompose=n, external_product_crt=n),
            "scan1": dict(pbs_step=n),
            "scan3": dict(rotate_decompose=n, ntt_mac_prime=n * P,
                          crt_accumulate=n),
            "scan1w": dict(pbs_step_single_cta=n),
            "grid": dict(blind_rotate_persistent=1),
            "mega": dict(blind_rotate_single_cta=1)}
    outs = {}
    for mode in fused_pbs.MODES:
        fused_pbs.reset_launch_counts()
        outs[mode] = fused_pbs.blind_rotate_fused(key, acc, ahat, mode)
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in fused_pbs.KERNELS
                    if fn.launches}
        assert launches == want[mode], mode
    for mode in fused_pbs.MODES:
        assert torch.equal(outs[mode], outs["scan2"]), mode


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("width", CORE_WIDTHS, ids=CORE_WIDTH_IDS)
def test_single_cta_rotation_on_the_core_matches_plain(width, B, card):
    rng = np.random.default_rng([31, B])
    key, acc, ahat = _inputs(rng, dict(width, n=3, B=B), card)
    bl, L, bits = key.base_log, key.levels, key.bits
    fused_pbs.reset_launch_counts()
    got = fused_pbs.blind_rotate_single_cta(acc, ahat, key.kspec, key.kshoup,
                                            bl, L, bits)
    torch.cuda.synchronize()
    assert fused_pbs.blind_rotate_single_cta.launches == 1
    assert torch.equal(got, fused_pbs.blind_rotate_persistent_plain(
        acc, ahat, key.kspec, bl, L, bits))


@pytest.mark.parametrize("B", [64, 256])
@pytest.mark.parametrize("width,n", [(CORE_WIDTHS[0], 742),
                                     (CORE_WIDTHS[1], 722)],
                         ids=["shortint742", "boolean722"])
def test_single_cta_rotation_on_the_core_at_the_main_paths_depth(width, n, B,
                                                                card):
    # the main paths' batches; on an H100 the shortint B = 256 runs one CTA
    # per ciphertext, the others a cluster of P
    rng = np.random.default_rng([37, B])
    key, acc, ahat = _inputs(rng, dict(width, n=n, B=B), card)
    bl, L, bits = key.base_log, key.levels, key.bits
    form = fused_pbs.blind_rotate_single_cta_form(B, width["N"], width["G"],
                                                  L, bits)
    got = fused_pbs.blind_rotate_single_cta(acc, ahat, key.kspec, key.kshoup,
                                            bl, L, bits)
    torch.cuda.synchronize()
    assert torch.equal(got, fused_pbs.blind_rotate_persistent_plain(
        acc, ahat, key.kspec, bl, L, bits)), form


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("width", CORE_WIDTHS, ids=CORE_WIDTH_IDS)
def test_persistent_rotation_on_the_core_matches_plain(width, B, card):
    # K5: K4's cluster step looped on chip, one launch a rotation
    rng = np.random.default_rng([29, B])
    key, acc, ahat = _inputs(rng, dict(width, n=3, B=B), card)
    bl, L, bits = key.base_log, key.levels, key.bits
    fused_pbs.reset_launch_counts()
    got = fused_pbs.blind_rotate_persistent(acc, ahat, key.kspec, key.kshoup,
                                            bl, L, bits)
    torch.cuda.synchronize()
    assert launched() == {"blind_rotate_persistent": 1}
    assert torch.equal(got, fused_pbs.blind_rotate_persistent_plain(
        acc, ahat, key.kspec, bl, L, bits))


@pytest.mark.parametrize("B", [64, 256])
@pytest.mark.parametrize("width,n", [(CORE_WIDTHS[0], 742),
                                     (CORE_WIDTHS[1], 722)],
                         ids=["shortint742", "boolean722"])
def test_persistent_rotation_at_the_main_paths_depth(width, n, B, card):
    # every step reads the words the last one wrote in place: a stale word
    # anywhere would show here
    rng = np.random.default_rng([53, B])
    key, acc, ahat = _inputs(rng, dict(width, n=n, B=B), card)
    bl, L, bits = key.base_log, key.levels, key.bits
    waves = fused_pbs.blind_rotate_persistent_waves(B, width["N"],
                                                    width["G"], L, bits)
    assert waves["waves"] == -(-B // waves["clusters"]) >= 1
    got = fused_pbs.blind_rotate_persistent(acc, ahat, key.kspec, key.kshoup,
                                            bl, L, bits)
    torch.cuda.synchronize()
    assert torch.equal(got, fused_pbs.blind_rotate_persistent_plain(
        acc, ahat, key.kspec, bl, L, bits)), waves


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("width", CORE_WIDTHS, ids=CORE_WIDTH_IDS)
def test_step_on_the_core_matches_plain(width, B, card):
    # K4: one launch a step, the digits made inside (a cluster per
    # ciphertext, or one CTA where that fills the card in fewer waves); K3
    # runs the same kernel and counts its launch as its own
    rng = np.random.default_rng([41, B])
    key, acc, ahat = _inputs(rng, dict(width, n=1, B=B), card)
    bl, L, bits = key.base_log, key.levels, key.bits
    want = fused_pbs.pbs_step_plain(acc, ahat[0], key.kspec[0], bl, L, bits)
    for wrapper in (fused_pbs.pbs_step_single_cta, fused_pbs.pbs_step):
        fused_pbs.reset_launch_counts()
        got = wrapper(acc, ahat[0], key.kspec[0], key.kshoup[0], bl, L, bits)
        torch.cuda.synchronize()
        assert launched() == {wrapper.__name__: 1}
        assert torch.equal(got, want), wrapper.__name__


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("width", CORE_WIDTHS, ids=CORE_WIDTH_IDS)
def test_prime_stage_on_the_core_matches_plain(width, B, card):
    # K6's ntt_mac_prime: one launch per prime, each writing only its rows
    rng = np.random.default_rng([43, B])
    key, acc, ahat = _inputs(rng, dict(width, n=1, B=B), card)
    bl, L, bits = key.base_log, key.levels, key.bits
    G, N = width["G"], width["N"]
    M = 2 if bits == 64 else 1
    dig = fused_pbs.rotate_decompose_plain(acc, ahat[0], bl, L, bits)
    got = torch.full((B, G, M, P, N), -1, dtype=torch.int32, device=card)
    want = torch.full_like(got, -1)
    fused_pbs.reset_launch_counts()
    for pi in range(P):
        fused_pbs.ntt_mac_prime(dig, key.kspec[0, pi], key.kshoup[0, pi], pi,
                                got)
        fused_pbs.ntt_mac_prime_plain(dig, key.kspec[0, pi], pi, want)
        torch.cuda.synchronize()
        assert torch.equal(got, want), pi
    assert fused_pbs.ntt_mac_prime.launches == P


def _residues_below_2_67(rng, B, O, M, N):
    """Canonical residues [B, O, M, P, N] int32 of integers x = hi 2^34 + lo
    with |x| < 2^67 (every convolution K6 reconstructs), the first and the
    last ciphertext's first and last 4 words at the extremes: x = 0 and
    x = -1 (residues 0 and p - 1 for every prime), x = +-(2^67 - 1)."""
    hi = rng.integers(-2**33 + 1, 2**33, (B, O, M, N))
    lo = rng.integers(0, 2**34, (B, O, M, N))
    ends = [(0, 0), (-1, 2**34 - 1), (2**33 - 1, 2**34 - 1), (-2**33, 1)]
    for b, n0 in ((0, 0), (B - 1, N - 4)):
        for k, (h, low) in enumerate(ends):
            hi[b, 0, 0, n0 + k], lo[b, 0, 0, n0 + k] = h, low
    res = np.stack([((hi % p) * (2**34 % p) + lo % p) % p
                    for p in ntt.PRIMES], axis=3)
    return torch.from_numpy(res.astype(np.int32))


@pytest.mark.parametrize("B", [1, 3, 64, 256])
@pytest.mark.parametrize("N", [256, 512, 1024, 2048])
@pytest.mark.parametrize("bits", [64, 32])
def test_crt_stage_matches_plain(bits, N, B, card):
    # K6's crt_accumulate: 4 coefficients a thread, the explicit CRT; B = 1
    # and 3 leave the last block part empty (B O N / 4 threads)
    rng = np.random.default_rng([47, B, N, bits])
    O, M = (2, 2) if bits == 64 else (3, 1)
    res = _residues_below_2_67(rng, B, O, M, N).to(card)
    acc = torch.from_numpy(rng.integers(0, 2**bits - 1, (B, O, N),
                                        dtype=np.uint64, endpoint=True)
                           .view(np.int64)).to(card)
    fused_pbs.reset_launch_counts()
    got = fused_pbs.crt_accumulate(res, acc, bits)
    torch.cuda.synchronize()
    assert launched() == {"crt_accumulate": 1}
    assert torch.equal(got, fused_pbs.crt_accumulate_plain(res, acc, bits))


def test_crt_stage_refuses_misaligned_inputs(card):
    # the kernel reads 16 bytes at a time: a view 4 or 8 bytes into a
    # buffer is refused before any launch
    B, O, M, N = 2, 2, 2, 256
    res = torch.zeros(B * O * M * P * N + 4, dtype=torch.int32, device=card)
    acc = torch.zeros(B * O * N + 2, dtype=torch.int64, device=card)
    fused_pbs.reset_launch_counts()
    with pytest.raises(ValueError, match="aligned"):
        fused_pbs.crt_accumulate(res[1:1 + B * O * M * P * N].view(
            B, O, M, P, N), acc[:B * O * N].view(B, O, N))
    with pytest.raises(ValueError, match="aligned"):
        fused_pbs.crt_accumulate(res[:B * O * M * P * N].view(
            B, O, M, P, N), acc[1:1 + B * O * N].view(B, O, N))
    assert launched() == {}


def test_empty_batch_launches_nothing_in_any_mode(card):
    key = fused_pbs.prepare_bsk_cuda(
        torch.zeros((2, 3, 3, 3, 512), dtype=torch.int64, device=card), 6, 32)
    acc = torch.zeros((0, 3, 512), dtype=torch.int64, device=card)
    ahat = torch.zeros((2, 0), dtype=torch.int32, device=card)
    fused_pbs.reset_launch_counts()
    for mode in fused_pbs.MODES:
        out = fused_pbs.blind_rotate_fused(key, acc, ahat, mode)
        assert out.shape == (0, 3, 512)
    torch.cuda.synchronize()
    assert [k.launches for k in fused_pbs.KERNELS] == [0] * len(
        fused_pbs.KERNELS)


def test_persistent_batch_beyond_65535(card):
    # one cluster per ciphertext on grid.x: 65544 ciphertexts in one launch
    rng = np.random.default_rng(19)
    case = dict(n=2, L=1, G=2, N=256, B=65536 + 8, bl=23, bits=64)
    key, acc, ahat = _inputs(rng, case, card)
    out = fused_pbs.blind_rotate_persistent(acc, ahat, key.kspec, key.kshoup,
                                            23, 1)
    rows = torch.cat([torch.arange(8), torch.arange(case["B"] - 16,
                                                    case["B"])]).to(card)
    want = fused_pbs.blind_rotate_persistent_plain(
        acc[rows], ahat[:, rows].contiguous(), key.kspec, 23, 1)
    torch.cuda.synchronize()
    assert torch.equal(out[rows], want)


def test_single_cta_batch_beyond_65535(card):
    # one CTA per ciphertext on grid.x: 65544 ciphertexts in one launch
    rng = np.random.default_rng(23)
    case = dict(n=2, L=1, G=2, N=256, B=65536 + 8, bl=23, bits=64)
    key, acc, ahat = _inputs(rng, case, card)
    out = fused_pbs.blind_rotate_single_cta(acc, ahat, key.kspec, key.kshoup,
                                            23, 1)
    rows = torch.cat([torch.arange(8), torch.arange(case["B"] - 16,
                                                    case["B"])]).to(card)
    want = fused_pbs.blind_rotate_persistent_plain(
        acc[rows], ahat[:, rows].contiguous(), key.kspec, 23, 1)
    torch.cuda.synchronize()
    assert torch.equal(out[rows], want)


def test_layouts_beyond_the_kernels_limits_are_refused(card):
    # bad dtypes and shapes are refused by the wrappers
    acc = torch.zeros((2, 2, 256), dtype=torch.int64, device=card)
    key = fused_pbs.prepare_bsk_cuda(
        torch.zeros((1, 1, 2, 2, 256), dtype=torch.int64, device=card), 23)
    ahat = torch.zeros((1, 2), dtype=torch.int32, device=card)
    with pytest.raises(ValueError):
        fused_pbs.pbs_step(acc, ahat[0].long(), key.kspec[0], key.kshoup[0],
                           23, 1)
    with pytest.raises(ValueError):
        fused_pbs.blind_rotate_persistent(acc, ahat, key.kspec[:, :3],
                                          key.kshoup, 23, 1)
    res = torch.zeros((2, 2, 2, P, 256), dtype=torch.int32, device=card)
    dig = torch.zeros((2, 1, 2, 256), dtype=torch.int32, device=card)
    with pytest.raises(ValueError):
        fused_pbs.ntt_mac_prime(dig, key.kspec[0, 0], key.kshoup[0, 0], P,
                                res)
    with pytest.raises(ValueError):
        fused_pbs.crt_accumulate(res, acc, bits=32)
    # a whole rotation (K5) on the register-resident core with L*G = 20
    # digit polynomials (G = 4, L = 5 at N = 2048), beyond the core's 18,
    # is refused by the C entry point, under K5's name
    G, L, N = 4, 5, 2048
    big = fused_pbs.prepare_bsk_cuda(
        torch.zeros((1, L, G, G, N), dtype=torch.int64, device=card), 8)
    acc = torch.zeros((1, G, N), dtype=torch.int64, device=card)
    with pytest.raises(RuntimeError, match="^blind_rotate_persistent: "
                       ".*cudaErrorInvalidValue"):
        fused_pbs.blind_rotate_persistent(
            acc, torch.zeros((1, 1), dtype=torch.int32, device=card),
            big.kspec, big.kshoup, 8, L)
    # and so are a whole step (K4, and K3, on K4's kernel) and one prime's
    # stage (K6) on the register-resident core at that layout
    ahat1 = torch.zeros((1, 1), dtype=torch.int32, device=card)
    # (each refusal under its own wrapper's name)
    with pytest.raises(RuntimeError,
                       match="^pbs_step_single_cta: .*cudaErrorInvalidValue"):
        fused_pbs.pbs_step_single_cta(acc, ahat1[0], big.kspec[0],
                                      big.kshoup[0], 8, L)
    with pytest.raises(RuntimeError,
                       match="^pbs_step: .*cudaErrorInvalidValue"):
        fused_pbs.pbs_step(acc, ahat1[0], big.kspec[0], big.kshoup[0], 8, L)
    with pytest.raises(RuntimeError, match="cudaErrorInvalidValue"):
        fused_pbs.blind_rotate_single_cta(acc, ahat1, big.kspec, big.kshoup,
                                          8, L)
    dig20 = torch.zeros((1, L, G, N), dtype=torch.int32, device=card)
    res20 = torch.zeros((1, G, 2, P, N), dtype=torch.int32, device=card)
    with pytest.raises(RuntimeError, match="cudaErrorInvalidValue"):
        fused_pbs.ntt_mac_prime(dig20, big.kspec[0, 0], big.kshoup[0, 0], 0,
                                res20)
    # and an N outside 256 ... 2048, by the core's tables
    small = fused_pbs.prepare_bsk_cuda(
        torch.zeros((1, 1, 2, 2, 128), dtype=torch.int64, device=card), 23)
    for step in (fused_pbs.pbs_step_single_cta, fused_pbs.pbs_step):
        with pytest.raises(ValueError):
            step(torch.zeros((1, 2, 128), dtype=torch.int64, device=card),
                 ahat1[0], small.kspec[0], small.kshoup[0], 23, 1)
    with pytest.raises(ValueError, match="^blind_rotate_persistent: N = 128 "):
        fused_pbs.blind_rotate_persistent(
            torch.zeros((1, 2, 128), dtype=torch.int64, device=card), ahat1,
            small.kspec, small.kshoup, 23, 1)
    with pytest.raises(ValueError):
        fused_pbs.ntt_mac_prime(
            torch.zeros((1, 1, 2, 128), dtype=torch.int32, device=card),
            small.kspec[0, 0], small.kshoup[0, 0], 0,
            torch.zeros((1, 2, 2, P, 128), dtype=torch.int32, device=card))
    with pytest.raises(ValueError):
        fused_pbs.blind_rotate_single_cta(acc, ahat1.long(), big.kspec,
                                          big.kshoup, 8, L)
