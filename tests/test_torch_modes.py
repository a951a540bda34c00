"""The port's classic blind rotation in every schedule of
`fused_pbs.MODES` (on the CPU: the plain versions of each schedule's
kernels) == tfhe_tpu.core.blind_rotate on the reference's CRT-NTT path, bit
for bit, at the tests/test_fused_pbs.py cases; and the pieces each schedule
is made of agree with each other."""

import functools

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
    M = 2 if bits == 64 else 1
    residues = torch.full((B, G, M, len(ntt.PRIMES), N), -1,
                          dtype=torch.int32)
    for pi in range(len(ntt.PRIMES)):
        out = fused_pbs.ntt_mac_prime(digits, key.kspec[0, pi],
                                      key.kshoup[0, pi], pi, residues)
        assert out is residues
        assert bool((residues[:, :, :, pi] >= 0).all())
        assert bool((residues[:, :, :, pi] < ntt.PRIMES[pi]).all())
    k2 = fused_pbs.external_product_crt(digits, key.kspec[0], key.kshoup[0],
                                        acc, bits)
    assert torch.equal(fused_pbs.crt_accumulate(residues, acc, bits), k2)
    step = fused_pbs.pbs_step(acc, ahat[0], key.kspec[0], key.kshoup[0], bl,
                              L, bits)
    assert torch.equal(step, k2)
    step_w = fused_pbs.pbs_step_single_cta(acc, ahat[0], key.kspec[0],
                                           key.kshoup[0], bl, L, bits)
    assert torch.equal(step_w, k2)
    rot = fused_pbs.blind_rotate_persistent(acc, ahat, key.kspec, key.kshoup,
                                            bl, L, bits)
    assert torch.equal(fused_pbs.blind_rotate_single_cta(
        acc, ahat, key.kspec, key.kshoup, bl, L, bits), rot)
    for mode in fused_pbs.MODES:
        assert torch.equal(fused_pbs.blind_rotate_fused(key, acc, ahat, mode),
                           rot)


@pytest.mark.parametrize("N", [256, 512, 2048])
def test_explicit_crt_constants_reconstruct_the_convolution(N):
    # the single-CTA kernels' CRT, in Python integers: from the unscaled
    # inverse transforms r_i = N x mod p_i of a convolution x with
    # |x| < 2^67, c_i = r_i w_i mod p_i, the u32 fraction sum_i c_i T_i,
    # k = round(fraction / 2^28), and x = sum_i c_i Q_i - k Q mod 2^64
    tab = ntt.tables_for(N, "cpu").xcrt.tolist()
    rng = np.random.default_rng(N)
    xs = [int(v) for v in rng.integers(-2**62, 2**62, 200)]
    xs += [v * 32 + 7 for v in xs[:50]]
    xs += [2**67 - 1, -(2**67 - 1), 0, 1, -1]
    u64 = lambda v: v % (1 << 64)  # noqa: E731
    for x in xs:
        acc, frac = 0, 0
        for p, w, wsh, q_i, t, q in tab:
            r = N * x % p
            c = r * w % p
            assert c == (r * w - (r * wsh >> 32) * p) % p  # the Shoup form
            frac += c * t
            acc += c * u64(q_i)
        assert frac < 1 << 32
        k = (frac + (1 << (ntt.XCRT_FRAC_BITS - 1))) >> ntt.XCRT_FRAC_BITS
        assert u64(acc - k * u64(tab[0][5])) == u64(x), x


def _residue_crt_word(r, consts):
    """crt_accumulate's kernel on one plane, in Python integers: canonical
    residues r_i -> (c_i, the u32 fraction sum_i c_i T_i, k, the word
    sum_i c_i Q_i - k Q mod 2^64)."""
    u64 = lambda v: v % (1 << 64)  # noqa: E731
    cs, acc, frac = [], 0, 0
    for ri, (p, w, wsh, q_i, t, _) in zip(r, consts):
        c = ri * w % p
        assert c == (ri * w - (ri * wsh >> 32) * p) % p  # the Shoup form
        cs.append(c)
        frac += c * t
        acc += c * u64(q_i)
    assert frac < 1 << 32
    k = (frac + (1 << (ntt.XCRT_FRAC_BITS - 1))) >> ntt.XCRT_FRAC_BITS
    return cs, frac, k, u64(acc - k * u64(consts[0][5]))


def test_residue_crt_constants_match_garner_over_the_whole_range():
    # crt_accumulate's constants (ntt.residue_crt_for) against Garner's
    # balanced reconstruction (ntt.crt_to_u64_centered, the plain version)
    # for residue tuples drawn over the whole 5-prime range: the c_i
    # recombine to Garner's integer exactly with the exact k = round(sum_i
    # c_i / p_i); the kernel's 28-bit fraction gives that k wherever the
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
    want = to_numpy(fused_pbs.crt_accumulate_plain(res, acc, bits), bits)
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
    step = fused_pbs.pbs_step_single_cta(acc, ahat[0], key.kspec[0],
                                         key.kshoup[0], bl, L)
    assert torch.equal(step, fused_pbs.pbs_step_plain(acc, ahat[0],
                                                      key.kspec[0], bl, L))
    rot = fused_pbs.blind_rotate_single_cta(acc, ahat, key.kspec, key.kshoup,
                                            bl, L)
    assert torch.equal(rot, fused_pbs.blind_rotate_persistent_plain(
        acc, ahat, key.kspec, bl, L))
    assert (fused_pbs.pbs_step_single_cta.launches,
            fused_pbs.blind_rotate_single_cta.launches) == (0, 0)
    meta = [t.to("meta") for t in (acc, ahat, key.kspec, key.kshoup)]
    with pytest.raises(ValueError, match="unsupported device"):
        fused_pbs.pbs_step_single_cta(meta[0], meta[1][0], meta[2][0],
                                      meta[3][0], bl, L)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_pbs.blind_rotate_single_cta(*meta, bl, L)


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
