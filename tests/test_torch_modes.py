"""The port's classic blind rotation in every schedule of
`fused_pbs.MODES` (on the CPU: the plain versions of each schedule's
kernels) == tfhe_tpu.core.blind_rotate on the reference's CRT-NTT path, bit
for bit, at the tests/test_fused_pbs.py cases; and the pieces each schedule
is made of agree with each other."""

import functools
import random

import numpy as np
import pytest
import torch

from tfhe_tpu.core import pbs as ref_pbs
from tfhe_tpu.ops.polymul_ntt import prepare_bsk_ntt

from tfhe_tpu_torch import core
from tfhe_tpu_torch.ops import fused_pbs, ntt
from tfhe_tpu_torch.ops.torus import to_numpy, to_tensor
from test_torch_cases import CASES, IDS, rand_inputs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run thousands of small tensor ops; one thread
    each keeps them fast when several test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.cache
def _reference(i):
    case = CASES[i]
    rng = np.random.default_rng(42)
    bsk_std, lut, lwe = rand_inputs(rng, *(case[k] for k in "nLGNB"),
                                    case["bits"])
    want = np.asarray(ref_pbs.blind_rotate(
        prepare_bsk_ntt(bsk_std, case["bl"], bits=case["bits"]), lut, lwe))
    return bsk_std, lut, lwe, want


@pytest.mark.parametrize("mode", fused_pbs.MODES)
@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_blind_rotate_matches_reference_in_every_mode(i, mode):
    bl, bits = CASES[i]["bl"], CASES[i]["bits"]
    bsk_std, lut, lwe, want = _reference(i)
    key = core.prepare_bsk_cuda(to_tensor(bsk_std, "cpu"), bl, bits)
    got = core.blind_rotate(key, to_tensor(lut, "cpu"), to_tensor(lwe, "cpu"),
                            mode=mode)
    assert np.array_equal(to_numpy(got, bits), want)


def _step_inputs(bits, seed=5, B=4, L=2, G=3, N=256, bl=8, n=3):
    rng = np.random.default_rng(seed)
    hi = 2**64 - 1 if bits == 64 else 2**32 - 1

    def words(*shape):
        return torch.from_numpy(rng.integers(0, hi, shape, dtype=np.uint64,
                                             endpoint=True).view(np.int64))

    key = fused_pbs.prepare_bsk_cuda(words(n, L, G, G, N), bl, bits)
    ahat = torch.from_numpy(rng.integers(0, 2 * N, (n, B), endpoint=True)
                            .astype(np.int32))
    ahat[0, 0] = 2 * N  # 2N rotates as 0 in every schedule
    ahat[1, 1] = 0
    return key, words(B, G, N), ahat


@pytest.mark.parametrize("bits", [64, 32])
def test_schedule_pieces_agree(bits):
    key, acc, ahat = _step_inputs(bits)
    bl, L = key.base_log, key.levels
    digits = fused_pbs.rotate_decompose(acc, ahat[0], bl, L, bits)
    B, _, G, N = digits.shape
    ps = {"primes": key.primes}
    residues = torch.full((B, G, key.planes, len(key.primes), N), -1,
                          dtype=torch.int32)
    for pi in range(len(key.primes)):
        out = fused_pbs.ntt_mac_prime(digits, key.kspec[0, pi],
                                      key.kshoup[0, pi], pi, residues, **ps)
        assert out is residues
        assert bool((residues[:, :, :, pi] >= 0).all())
        assert bool((residues[:, :, :, pi] < key.primes[pi]).all())
    k2 = fused_pbs.external_product_crt(digits, key.kspec[0], key.kshoup[0],
                                        acc, bits, **ps)
    assert torch.equal(fused_pbs.crt_accumulate(residues, acc, bits, **ps),
                       k2)
    step = fused_pbs.pbs_step(acc, ahat[0], key.kspec[0], key.kshoup[0], bl,
                              L, bits, **ps)
    assert torch.equal(step, k2)
    step_w = fused_pbs.pbs_step_single_cta(acc, ahat[0], key.kspec[0],
                                           key.kshoup[0], bl, L, bits, **ps)
    assert torch.equal(step_w, k2)
    rot = fused_pbs.blind_rotate_persistent(acc, ahat, key.kspec, key.kshoup,
                                            bl, L, bits, **ps)
    assert torch.equal(fused_pbs.blind_rotate_single_cta(
        acc, ahat, key.kspec, key.kshoup, bl, L, bits, **ps), rot)
    for mode in fused_pbs.MODES:
        assert torch.equal(fused_pbs.blind_rotate_fused(key, acc, ahat, mode),
                           rot)


def _explicit_crt_words(N, xs, primes):
    """The kernels' explicit CRT in Python integers: from the unscaled
    inverse transforms r_i = N x mod p_i of each convolution x,
    c_i = r_i w_i mod p_i, the u32 fraction sum_i hi(c_i T_i) (`__umulhi`),
    k = round(fraction / 2^F), and sum_i c_i Q_i - k Q mod 2^64."""
    tab = ntt.tables_for(N, "cpu", primes).xcrt.tolist()
    F = ntt.XCRT_FRAC_BITS
    u64 = lambda v: v % (1 << 64)  # noqa: E731
    out = []
    for x in xs:
        acc, frac = 0, 0
        for p, w, wsh, q_i, t, q in tab:
            r = N * x % p
            c = r * w % p
            assert c == (r * w - (r * wsh >> 32) * p) % p  # the Shoup form
            assert c < 1 << 32 and t < 1 << 32  # __umulhi's operands
            frac += c * t >> 32
            acc += c * u64(q_i)
        assert frac < 1 << 32
        k = (frac + (1 << (F - 1))) >> F
        out.append(u64(acc - k * u64(tab[0][5])))
    return out


@pytest.mark.parametrize("N", [256, 512, 2048])
def test_explicit_crt_constants_reconstruct_the_convolution(N):
    # the kernels' CRT on the five primes, for convolutions with |x| < 2^67
    rng = np.random.default_rng(N)
    xs = [int(v) for v in rng.integers(-2**62, 2**62, 200)]
    xs += [v * 32 + 7 for v in xs[:50]]
    xs += [2**67 - 1, -(2**67 - 1), 0, 1, -1]
    u64 = lambda v: v % (1 << 64)  # noqa: E731
    assert _explicit_crt_words(N, xs, ntt.PRIMES) == [u64(x) for x in xs]


@pytest.mark.parametrize("P", [2, 3, 4, 8])
@pytest.mark.parametrize("N", [256, 2048])
def test_explicit_crt_constants_reconstruct_on_the_classic_primes(N, P):
    # the same CRT on the first P of the classic key's primes, over the
    # whole range `holds_product` admits: |x| < Q (1/2 - P 2^(1 - F)), F
    # = 13, its two ends included, and at P = 4 the products of
    # PARAM_MESSAGE_2_CARRY_2_KS_PBS's one-plane key (|x| <= 2^97)
    primes = ntt.WIDE_PRIMES[:P]
    Q, F = 1, ntt.XCRT_FRAC_BITS
    for p in primes:
        Q *= p
    top = (Q * ((1 << (F - 1)) - 2 * P) - 1) >> F
    assert ntt.holds_product(primes, top)
    assert not ntt.holds_product(primes, top + 1)
    rng = random.Random(N + P)
    xs = [rng.randint(-top, top) for _ in range(200)]
    xs += [rng.randint(-2**40, 2**40) for _ in range(50)]
    xs += [top, -top, 0, 1, -1, top - 1, 1 - top]
    if P == 4:
        bound = ntt.product_bound(23, 2, 2048, 64, 1)
        assert bound == 2**97 and ntt.holds_product(primes, bound)
        xs += [bound, -bound, bound - 12345]
    u64 = lambda v: v % (1 << 64)  # noqa: E731
    assert _explicit_crt_words(N, xs, primes) == [u64(x) for x in xs]


def test_explicit_crt_constants_of_the_classic_primes():
    # F = 13: T_i = round(2^(32 + F) / p_i) fits a u32 for every prime of
    # both sets (each above 2^13), each high word hi(c_i T_i) of a c_i <
    # p_i is at most 2^F, so P <= 8 of them and the rounding's 2^(F - 1)
    # sum in a u32; w_i is N^-1 (Q / p_i)^-1 mod p_i with its Shoup
    # companion
    F = ntt.XCRT_FRAC_BITS
    assert min(ntt.PRIMES + ntt.WIDE_PRIMES) > 1 << F
    for N in (1, 256, 2048):
        tab = ntt._explicit_crt_host(N, ntt.WIDE_PRIMES)
        if N > 1:
            assert tab.tolist() == ntt.tables_for(
                N, "cpu", ntt.WIDE_PRIMES).xcrt.tolist()
        Q = 1
        for p in ntt.WIDE_PRIMES:
            Q *= p
        for (p, w, wsh, q_i, t, q), pr in zip(tab.tolist(),
                                             ntt.WIDE_PRIMES):
            assert p == pr
            assert w == pow(N, -1, p) * pow(Q // p, -1, p) % p
            assert wsh == (w << 32) // p
            assert q_i % (1 << 64) == (Q // p) % (1 << 64)
            assert q % (1 << 64) == Q % (1 << 64)
            assert t == ((1 << (32 + F)) + p // 2) // p < 1 << 32
            assert (p - 1) * t >> 32 <= 1 << F
        assert len(tab) * ((1 << F) + 1) + (1 << (F - 1)) < 1 << 32
    assert ntt.residue_crt_for("cpu", ntt.WIDE_PRIMES[:4]).tolist() == \
        ntt._explicit_crt_host(1, ntt.WIDE_PRIMES[:4]).tolist()


def _residue_crt_word(r, consts):
    """crt_accumulate's kernel on one plane, in Python integers: canonical
    residues r_i -> (c_i, the u32 fraction sum_i hi(c_i T_i), k, the word
    sum_i c_i Q_i - k Q mod 2^64)."""
    u64 = lambda v: v % (1 << 64)  # noqa: E731
    F = ntt.XCRT_FRAC_BITS
    cs, acc, frac = [], 0, 0
    for ri, (p, w, wsh, q_i, t, _) in zip(r, consts):
        c = ri * w % p
        assert c == (ri * w - (ri * wsh >> 32) * p) % p  # the Shoup form
        cs.append(c)
        frac += c * t >> 32
        acc += c * u64(q_i)
    assert frac < 1 << 32
    k = (frac + (1 << (F - 1))) >> F
    return cs, frac, k, u64(acc - k * u64(consts[0][5]))


def test_residue_crt_constants_match_garner_over_the_whole_range():
    # crt_accumulate's constants (ntt.residue_crt_for) against Garner's
    # balanced reconstruction (ntt.crt_to_u64_centered, the plain version)
    # for residue tuples drawn over the whole 5-prime range: the c_i
    # recombine to Garner's integer exactly with the exact k = round(sum_i
    # c_i / p_i); the kernel's 13-bit fraction gives that k wherever the
    # exact fraction lies more than P 2^-12 from a half, which every
    # integer below 2^67 in magnitude does (|x| / Q < 2^-10)
    from fractions import Fraction

    consts = ntt.residue_crt_for("cpu").tolist()
    assert consts == ntt._explicit_crt_host(1).tolist()
    primes = [int(p) for p in ntt.PRIMES]
    Q = ntt.CRT_MODULUS
    rng = np.random.default_rng(7)
    tuples = [[int(rng.integers(0, p)) for p in primes] for _ in range(251)]
    tuples += [[0] * 5, [p - 1 for p in primes], [1] * 5,
               [p // 2 for p in primes], [(p + 1) // 2 for p in primes]]
    # [1, P, 256]: the plain version's tables are for a power-of-two N
    res = torch.tensor(tuples, dtype=torch.int64).T.reshape(1, 5, -1)
    garner = ntt.crt_to_u64_centered(res)[0].tolist()
    u64 = lambda v: v % (1 << 64)  # noqa: E731
    for r, g in zip(tuples, garner):
        x = sum(ri * pow(Q // p, -1, p) * (Q // p) for ri, p in
                zip(r, primes)) % Q
        x = x - Q if x > Q // 2 else x  # the balanced integer
        assert u64(x) == u64(g)
        cs, frac, k, word = _residue_crt_word(r, consts)
        exact = sum(Fraction(c, p) for c, p in zip(cs, primes))
        k_exact = round(exact)
        assert sum(c * (Q // p) for c, p in zip(cs, primes)) - k_exact * Q \
            == x
        if abs(exact - int(exact) - Fraction(1, 2)) > Fraction(5, 2**12):
            assert (k, word) == (k_exact, u64(x))


@pytest.mark.parametrize("bits", [64, 32])
def test_residue_crt_reconstructs_convolutions_below_2_67(bits):
    # the kernel's arithmetic on the residues of integers |x| < 2^67 (every
    # convolution K6 reconstructs), the extremes among them (x = 0 and
    # x = -1, whose residues are 0 and p - 1 for every prime), equals
    # crt_accumulate_plain word for word
    consts = ntt.residue_crt_for("cpu").tolist()
    rng = np.random.default_rng(bits)
    M, N, B, O = (2 if bits == 64 else 1), 8, 3, 2
    xs = [int(a) * 2**34 + int(b) for a, b in zip(
        rng.integers(-2**33 + 1, 2**33, B * O * M * N),
        rng.integers(0, 2**34, B * O * M * N))]
    xs[:4] = [0, -1, 2**67 - 1, -(2**67 - 1)]
    res = torch.tensor([[x % int(p) for p in ntt.PRIMES] for x in xs],
                       dtype=torch.int32).reshape(B, O, M, N, 5)
    res = res.permute(0, 1, 2, 4, 3).contiguous()
    acc = to_tensor(rng.integers(0, 2**bits - 1, (B, O, N),
                                 dtype=np.uint64, endpoint=True), "cpu")
    u64 = lambda v: v % (1 << 64)  # noqa: E731
    want = to_numpy(fused_pbs.crt_accumulate_plain(res, acc, bits,
                                                   primes=ntt.PRIMES), bits)
    a = to_numpy(acc, bits)
    for b in range(B):
        for o in range(O):
            for n in range(N):
                total = int(a[b, o, n])
                for m in range(M):
                    r = res[b, o, m, :, n].tolist()
                    total += _residue_crt_word(r, consts)[3] << (32 * m)
                assert u64(total) % (1 << bits) == int(want[b, o, n])


def test_single_cta_wrappers_take_the_plain_version_for_cpu_tensors_only():
    key, acc, ahat = _step_inputs(64)
    bl, L = key.base_log, key.levels
    fused_pbs.reset_launch_counts()
    ps = {"primes": key.primes}
    step = fused_pbs.pbs_step_single_cta(acc, ahat[0], key.kspec[0],
                                         key.kshoup[0], bl, L, **ps)
    assert torch.equal(step, fused_pbs.pbs_step_plain(acc, ahat[0],
                                                      key.kspec[0], bl, L,
                                                      **ps))
    rot = fused_pbs.blind_rotate_single_cta(acc, ahat, key.kspec, key.kshoup,
                                            bl, L, **ps)
    assert torch.equal(rot, fused_pbs.blind_rotate_persistent_plain(
        acc, ahat, key.kspec, bl, L, **ps))
    assert (fused_pbs.pbs_step_single_cta.launches,
            fused_pbs.blind_rotate_single_cta.launches) == (0, 0)
    meta = [t.to("meta") for t in (acc, ahat, key.kspec, key.kshoup)]
    with pytest.raises(ValueError, match="unsupported device"):
        fused_pbs.pbs_step_single_cta(meta[0], meta[1][0], meta[2][0],
                                      meta[3][0], bl, L, **ps)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_pbs.blind_rotate_single_cta(*meta, bl, L, **ps)


def test_rotation_by_2n_is_the_identity_in_every_mode():
    key, acc, _ = _step_inputs(64)
    N = acc.shape[-1]
    full = torch.full((key.input_dim, acc.shape[0]), 2 * N, dtype=torch.int32)
    zero = torch.zeros_like(full)
    for mode in fused_pbs.MODES:
        assert torch.equal(fused_pbs.blind_rotate_fused(key, acc, full, mode),
                           acc)
        assert torch.equal(fused_pbs.blind_rotate_fused(key, acc, zero, mode),
                           acc)


def test_unknown_mode_is_refused():
    key, acc, ahat = _step_inputs(64)
    for mode in ("scan1x", "megakernel", "", "SCAN2"):
        with pytest.raises(ValueError, match="mode"):
            fused_pbs.blind_rotate_fused(key, acc, ahat, mode)
    lwe = torch.zeros((2, key.input_dim + 1), dtype=torch.int64)
    with pytest.raises(ValueError, match="mode"):
        core.programmable_bootstrap(key, acc[0], lwe, mode="grid2")
