"""A plain PyTorch model of the register-resident NTT core
(tfhe_tpu_torch/ops/csrc/ntt_core.cuh), which K2 `external_product_crt`
and K7 `blind_rotate_single_cta` run on, checked word for word on the CPU.

The model does what the kernel's threads do: the same passes
(`ntt.pass_plan`), the same words per thread (`elem`), the twiddle records
the kernel reads (`ntt.pass_tables_for`, as uint32), the same lazy 32-bit
arithmetic (every word below 2^32, wrapped as the card wraps it), the digit
reduction by a Shoup product after an offset of 2^31, and the fused last
forward pass, spectral MAC and first inverse pass on one thread's 8
adjacent spectral words.  Checked: the transforms equal `ntt.forward_ntt` /
`inverse_ntt` for every prime at N = 256 ... 2048; the model's external
product equals `external_product_crt_plain` and, through a blind rotation
in schedule scan2, the reference's Pallas `fused_blind_rotate_scan2`
(`pc_kernel` -> `_primes_crt_math`, interpreted) at the four
tests/test_fused_pbs.py cases; and the kernel's shared-memory swizzle is a
bijection that keeps every warp's access of every pass free of bank
conflicts."""

import numpy as np
import pytest
import torch

from tfhe_tpu.ops import fused_pbs as ref_fused

from tfhe_tpu_torch import core
from tfhe_tpu_torch.ops import fused_pbs, ntt
from tfhe_tpu_torch.ops.torus import to_numpy, to_tensor
from test_torch_cases import CASES, IDS, rand_inputs

R = ntt.PASS_LOG_RADIX
r = ntt.PASS_RADIX
M32 = 0xFFFFFFFF
SIZES = [256, 512, 1024, 2048]


def umulhi(a, b):
    """floor(a * b / 2^32) of uint32 words held in int64, without overflow."""
    return ((a >> 16) * b + (((a & 0xFFFF) * b) >> 16)) >> 16


def shoup_lazy(a, w, wsh, p):
    return (a * w - umulhi(a, wsh) * p) & M32


def umin(a, b):
    return torch.minimum(a & M32, b & M32)


def elem(T, a):
    """[T, r]: word k of thread tid in the layout of shift a."""
    tid = torch.arange(T)[:, None]
    k = torch.arange(r)[None, :]
    return ((tid >> a) << (a + R)) | (k << a) | (tid & ((1 << a) - 1))


def swz(j):
    return j ^ (((j >> 6) & 3) << 3) ^ (((j >> 5) & 1) << 2)


class Core:
    """One prime's tables as the kernel reads them: prime index `prime` of
    the set `primes`."""

    def __init__(self, N, prime, primes=ntt.PRIMES):
        tab = ntt.pass_tables_for(N, "cpu", primes)[prime].to(
            torch.int64) & M32
        self.N, self.T = N, N // r
        self.p, self.p2, self.one_sh, self.off = (int(v) for v in tab[:4])
        self.c32, self.c32sh = (int(v) for v in tab[6:8])
        self.words = (tab.numel() - ntt.PASS_HEADER) // 2
        self.fwd = tab[ntt.PASS_HEADER:ntt.PASS_HEADER + self.words]
        self.inv = tab[ntt.PASS_HEADER + self.words:]
        self.s0, self.shifts = ntt.pass_plan(N)

    def records(self, table, off, a):
        """[T, r] twiddles and [T, r] companions of each thread's record."""
        tid = torch.arange(self.T)[:, None]
        rec = table[off + (tid >> a) * ntt.PASS_RECORD
                    + torch.arange(ntt.PASS_RECORD)[None, :]]
        return rec[:, :r], rec[:, r:]

    def forward_stages(self, x, w, wsh, stages):
        """x [..., T, r] in place: Cooley-Tukey stages of one pass."""
        for u in stages:
            half = r >> (u + 1)
            for k in range(r):
                if k & half:
                    continue
                t = (1 << u) - 1 + (k >> (R - u))
                v = shoup_lazy(x[..., k + half], w[:, t], wsh[:, t], self.p)
                x[..., k + half] = (x[..., k] - v + self.p2) & M32
                x[..., k] = (x[..., k] + v) & M32

    def inverse_stages(self, x, w, wsh, stages):
        """x [..., T, r] in place: Gentleman-Sande stages of one pass."""
        for u in stages:
            half = 1 << u
            for k in range(r):
                if k & half:
                    continue
                t = r - (r >> u) + (k >> (u + 1))
                a, b = x[..., k].clone(), x[..., k + half]
                s = (a + b) & M32
                x[..., k] = umin(s, s - self.p2)
                x[..., k + half] = shoup_lazy((a - b + self.p2) & M32,
                                              w[:, t], wsh[:, t], self.p)

    def digit_mod(self, d):
        """int32 digits -> words in [0, 3p) congruent to them."""
        return (shoup_lazy((d.to(torch.int64) + (1 << 31)) & M32, 1,
                           self.one_sh, self.p) + self.off) & M32

    def forward(self, x):
        """x [..., N] words -> the last pass's words [..., T, r] at
        elem(T, 0), lazy, left in registers."""
        buf = x.clone()
        off = 0
        for q, a in enumerate(self.shifts):
            w, wsh = self.records(self.fwd, off, a)
            off += (self.N >> (a + R)) * ntt.PASS_RECORD
            idx = elem(self.T, a)
            v = buf[..., idx]
            self.forward_stages(v, w, wsh, range(self.s0) if q == 0
                                else range(R))
            if q < len(self.shifts) - 1:
                buf[..., idx] = v
        return v

    def inverse(self, v):
        """v [..., T, r] words at elem(T, 0), in [0, 2p) -> [..., N] words
        in [0, 2p), unscaled; the first pass runs on v itself."""
        buf = torch.empty(*v.shape[:-2], self.N, dtype=torch.int64)
        off = 0
        for iq, a in enumerate(self.shifts[::-1]):
            w, wsh = self.records(self.inv, off, a)
            off += (self.N >> (a + R)) * ntt.PASS_RECORD
            idx = elem(self.T, a)
            if iq:
                v = buf[..., idx]
            last = iq == len(self.shifts) - 1
            self.inverse_stages(v, w, wsh, range(R - self.s0, R) if last
                                else range(R))
            buf[..., idx] = v
        return buf

    def reduce_u64(self, x):
        """x int64 >= 0 (a 64-bit sum) -> a word in [0, 2p) congruent to
        it, as `reduce_u64` of the core: its low word times 1 and its high
        word times 2^32 mod p by Shoup products, their sum less 2p unless
        it is below 2p."""
        s = (shoup_lazy(x & M32, 1, self.one_sh, self.p)
             + shoup_lazy(x >> 32, self.c32, self.c32sh, self.p))
        return umin(s, s - self.p2)

    def canonical(self, x, w=1, wsh=None):
        wsh = self.one_sh if wsh is None else wsh
        y = shoup_lazy(x, w, wsh, self.p)
        return umin(y, y - self.p)


def explicit_crt(c, acc, bits, primes=ntt.PRIMES):
    """c [B, O, M, P, N] (c_i = r_i N^-1 (Q/p_i)^-1 mod p_i over `primes`),
    acc [B, O, N] -> acc + the product, as the kernel's `crt_word` computes
    each word: per plane, sum_i c_i Q/p_i - round(sum_i hi(c_i t_i) / 2^F)
    Q (hi: `__umulhi`, the high word of the product), shifted by 32 m bits,
    with 64-bit (and, for the fraction, 32-bit) wrap."""
    x = ntt.tables_for(c.shape[-1], "cpu", primes).xcrt  # [P, 6] int64
    F = ntt.XCRT_FRAC_BITS
    c = c.to(torch.int64)
    total = acc.clone()
    for m in range(c.shape[2]):
        cm = c[:, :, m]  # [B, O, P, N]
        s = (cm * x[:, 3].view(1, 1, -1, 1)).sum(dim=2)  # wraps mod 2^64
        frac = ((cm * x[:, 4].view(1, 1, -1, 1)) >> 32).sum(dim=2) & M32
        k = (frac + (1 << (F - 1))) >> F
        total = total + ((s - k * x[0, 5]) << (32 * m))
    return total & M32 if bits == 32 else total


def prime_product(c, digits, kspec_p, kshoup_p):
    """One prime's external product as a CTA of the core computes it:
    digits [B, L, G, N], the prime's key block kspec_p / kshoup_p [LJ, O, M,
    N] -> its O*M unscaled inverse transforms [B, O*M, N] in [0, 2p): the
    digits' forward transforms, the MAC in the last pass's registers with
    the first inverse pass, the inverse passes."""
    B, L, G, N = digits.shape
    LJ, O, M, _ = kspec_p.shape
    d = c.forward(c.digit_mod(digits.reshape(B, LJ, N)))  # [B, LJ, T, r]
    # the thread's 8 adjacent spectral words of each key polynomial
    pos = elem(c.T, 0)
    ks = kspec_p.to(torch.int64).reshape(LJ, O * M, N)[..., pos] & M32
    ksh = kshoup_p.to(torch.int64).reshape(LJ, O * M, N)[..., pos] & M32
    o = torch.zeros((B, O * M, c.T, r), dtype=torch.int64)
    for lj in range(LJ):
        o = (o + shoup_lazy(d[:, lj, None], ks[lj], ksh[lj], c.p)) & M32
    # the first inverse pass runs on these registers, with no store
    return c.inverse(shoup_lazy(o, 1, c.one_sh, c.p))


def model_external_product(digits, kspec, kshoup, acc, bits,
                           primes=ntt.PRIMES):
    """K2 as the kernel computes it, on a key over `primes`: per prime (a
    CTA of the cluster), `prime_product`, then c_i = r_i w_i mod p_i; then
    the explicit CRT over the primes' values."""
    B, L, G, N = digits.shape
    P, LJ, O, M, _ = kspec.shape
    assert P == len(primes)
    xcrt = ntt.tables_for(N, "cpu", primes).xcrt
    res = torch.empty((B, O, M, P, N), dtype=torch.int64)
    for pi in range(P):
        c = Core(N, pi, primes)
        out = prime_product(c, digits, kspec[pi], kshoup[pi])  # [B, OM, N]
        res[:, :, :, pi] = c.canonical(out, int(xcrt[pi, 1]),
                                       int(xcrt[pi, 2])).reshape(B, O, M, N)
    return explicit_crt(res, acc, bits, primes)


def _transforms_equal_the_plain_ntt(N, primes):
    rng = np.random.default_rng(N)
    # signed digits of every magnitude the decompositions give, and the
    # int32 extremes
    d = torch.from_numpy(rng.integers(-2**22, 2**22, (3, N), endpoint=True)
                         .astype(np.int32))
    d[0, :4] = torch.tensor([-2**31, 2**31 - 1, 0, -1], dtype=torch.int32)
    want = ntt.forward_ntt(d.to(torch.int64), primes=primes)  # [3, P, N]
    spec = torch.from_numpy(rng.integers(0, 2**31, (3, len(primes), N)))
    spec = spec % ntt.tables_for(N, "cpu", primes).primes[:, None]
    want_inv = ntt.inverse_ntt(spec, primes=primes)
    pos = elem(N // r, 0).reshape(-1)
    for pi in range(len(primes)):
        c = Core(N, pi, primes)
        got = torch.empty((3, N), dtype=torch.int64)
        got[:, pos] = c.canonical(c.forward(c.digit_mod(d))).reshape(3, N)
        assert torch.equal(got, want[:, pi])
        x = spec[:, pi, pos].reshape(3, N // r, r)
        ninv = int(ntt.tables_for(N, "cpu", primes).n_inv[pi])
        out = c.canonical(c.inverse(x), ninv, (ninv << 32) // c.p)
        assert torch.equal(out, want_inv[:, pi])


@pytest.mark.parametrize("N", SIZES)
def test_transforms_equal_the_plain_ntt_for_every_prime(N):
    _transforms_equal_the_plain_ntt(N, ntt.PRIMES)


@pytest.mark.parametrize("N", SIZES)
def test_transforms_equal_the_plain_ntt_on_the_classic_primes(N):
    # the classic key's primes (below 2^26.83) through the same lazy
    # arithmetic: every word stays below 2^32 (the model wraps as the card
    # would, so an overflow would show as a wrong spectrum)
    _transforms_equal_the_plain_ntt(N, ntt.WIDE_PRIMES)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_external_product_equals_plain_and_the_reference(case, monkeypatch):
    rng = np.random.default_rng(42)
    bl, bits = case["bl"], case["bits"]
    bsk_std, lut, lwe = rand_inputs(rng, *(case[k] for k in "nLGNB"), bits)
    key = core.prepare_bsk_cuda(to_tensor(bsk_std, "cpu"), bl, bits)
    L, G, N = case["L"], case["G"], case["N"]
    acc = to_tensor(rng.integers(0, 2**bits - 1, (3, G, N), dtype=np.uint64,
                                 endpoint=True), "cpu")
    ahat = torch.from_numpy(rng.integers(0, 2 * N, (3,)).astype(np.int32))
    dig = fused_pbs.rotate_decompose_plain(acc, ahat, bl, L, bits)
    assert torch.equal(
        model_external_product(dig, key.kspec[0], key.kshoup[0], acc, bits,
                               key.primes),
        fused_pbs.external_product_crt_plain(dig, key.kspec[0], acc, bits,
                                             primes=key.primes))

    # a blind rotation in scan2 whose every K2 step is the model, against
    # the reference's scan2 Pallas kernels in interpret mode
    def model_k2(digits, kspec, kshoup, acc, bits=64, *, primes):
        return model_external_product(digits, kspec, kshoup, acc, bits,
                                      primes)

    monkeypatch.setattr(fused_pbs, "external_product_crt", model_k2)
    got = core.blind_rotate(key, to_tensor(lut, "cpu"), to_tensor(lwe, "cpu"),
                            mode="scan2")
    monkeypatch.setenv("TFHE_TPU_FUSED_MODE", "scan2")
    want = np.asarray(ref_fused.blind_rotate_fused(
        ref_fused.prepare_bsk_fused(bsk_std, bl, bits=bits), lut, lwe))
    assert np.array_equal(to_numpy(got, bits), want)


@pytest.mark.parametrize("N", SIZES)
def test_swizzle_is_a_bijection_without_bank_conflicts(N):
    j = torch.arange(N)
    assert torch.equal(torch.sort(swz(j)).values, j)
    T = N // r
    for a in sorted(set(ntt.pass_plan(N)[1])):
        phys = swz(elem(T, a))  # [T, r]
        for w0 in range(0, T, 32):
            warp = phys[w0:w0 + 32]
            if a == 0:
                # two 16-byte loads a thread; a quarter-warp's 8 chunks
                # must fall in 8 different 4-bank columns
                for half in (0, 4):
                    chunks = warp[:, half] >> 2
                    for q0 in range(0, chunks.numel(), 8):
                        cols = chunks[q0:q0 + 8] % 8
                        assert cols.unique().numel() == cols.numel()
                    assert torch.equal(warp[:, half:half + 4] - warp[:, half:
                                                                     half + 1],
                                       torch.arange(4).expand(len(warp), 4))
            else:
                for k in range(r):
                    banks = warp[:, k] % 32
                    assert banks.unique().numel() == banks.numel()


def _pass_tables_hold_the_twiddles(N, primes):
    # every twiddle a pass reads is psi^bitrev / psi^-bitrev at the index of
    # its butterfly group, and the companions are Shoup's
    tab = ntt.tables_for(N, "cpu", primes)
    for pi in (0, len(primes) - 1):
        c = Core(N, pi, primes)
        used = {False: set(), True: set()}
        for inverse, table, psi in ((False, c.fwd, tab.psi_rev[pi]),
                                    (True, c.inv, tab.psi_inv_rev[pi])):
            order = c.shifts[::-1] if inverse else c.shifts
            off = 0
            for q, a in enumerate(order):
                w, wsh = c.records(table, off, a)
                off += (N >> (a + R)) * ntt.PASS_RECORD
                assert torch.equal(wsh, (w << 32) // c.p)
                for tid in range(0, c.T, 1 if N == 256 else c.T // 16):
                    h = tid >> a
                    for u in range(R):
                        if inverse:
                            if q == len(order) - 1 and u < R - c.s0:
                                continue
                            m = 1 << (c.N.bit_length() - 1 - a - u - 1)
                            for cc in range(r >> (u + 1)):
                                i = m + (h << (R - 1 - u)) + cc
                                used[True].add(i)
                                assert w[tid, r - (r >> u) + cc] == psi[i]
                        else:
                            if q == 0 and u >= c.s0:
                                continue
                            m = 1 << (c.N.bit_length() - 1 - a - R + u)
                            for cc in range(1 << u):
                                i = m + (h << u) + cc
                                used[False].add(i)
                                assert w[tid, (1 << u) - 1 + cc] == psi[i]
            assert off == c.words
        if N == 256:  # every thread sampled: every twiddle index is read
            assert used[False] == used[True] == set(range(1, N))


@pytest.mark.parametrize("N", SIZES)
def test_pass_tables_hold_the_twiddles_of_the_passes(N):
    _pass_tables_hold_the_twiddles(N, ntt.PRIMES)


@pytest.mark.parametrize("N", SIZES)
def test_pass_tables_hold_the_twiddles_on_the_classic_primes(N):
    _pass_tables_hold_the_twiddles(N, ntt.WIDE_PRIMES)
    # the header: p, 2p, floor(2^32 / p), p - 2^31 mod p, N^-1, companion,
    # 2^32 mod p, companion
    head = ntt.pass_tables_for(N, "cpu", ntt.WIDE_PRIMES)[
        :, :ntt.PASS_HEADER].to(torch.int64) & M32
    for row, p in zip(head.tolist(), ntt.WIDE_PRIMES):
        assert row[:4] == [p, 2 * p, (1 << 32) // p, p - (1 << 31) % p]
        assert row[4] * N % p == 1 and row[5] == (row[4] << 32) // p
        assert row[6:] == [(1 << 32) % p, ((1 << 32) % p << 32) // p]


def test_classic_primes_are_primes_with_the_cores_headroom():
    # the eight largest primes == 1 mod 8192 below 2^32 / 36, largest
    # first: 25p < 2^32 (the forward transform's words) and 36p < 2^32 (the
    # MAC's sum at 18 digit polynomials), so the core's lazy arithmetic
    # holds for each; the reference's five hold it too
    assert len(ntt.WIDE_PRIMES) == ntt.MAX_PRIMES
    assert list(ntt.WIDE_PRIMES) == sorted(ntt.WIDE_PRIMES, reverse=True)
    for p in ntt.WIDE_PRIMES + ntt.PRIMES:
        assert all(p % d for d in range(2, int(p**0.5) + 1)), p
        assert 25 * p < 2**32 and 2 * 18 * p < 2**32
    limit = (2**32 - 1) // 36
    found = [p for p in range(limit - (limit - 1) % 8192, ntt.WIDE_PRIMES[-1]
                              - 1, -8192)
             if all(p % d for d in range(2, int(p**0.5) + 1))]
    assert tuple(found) == ntt.WIDE_PRIMES
    assert all(p % 8192 == 1 for p in ntt.WIDE_PRIMES)
    # a prime that breaks the MAC's headroom, or a composite, is refused
    big = next(p for p in range(limit + 1, limit + 10**4)
               if all(p % d for d in range(2, int(p**0.5) + 1)))
    with pytest.raises(ValueError, match="headroom"):
        ntt.check_headroom((big,))
    with pytest.raises(ValueError, match="not a prime"):
        ntt.check_headroom((119259137 * 3,))
    ntt.check_headroom(ntt.WIDE_PRIMES)


def test_classic_plan_follows_the_parameter_sets_widths():
    from tfhe_tpu_torch import params

    def plan(p, bits=64):
        return ntt.classic_plan(p.pbs_base_log, p.pbs_level,
                                p.glwe_dimension + 1, p.polynomial_size,
                                bits)

    # the benchmark's set: |x| <= 2 * 2048 * 2^22 * 2^63 = 2^97, so four
    # primes (2^107.3) and the key word whole
    assert plan(params.PARAM_MESSAGE_2_CARRY_2_KS_PBS) == (
        ntt.WIDE_PRIMES[:4], 1)
    assert ntt.product_bound(23, 2, 2048, 64, 1) == 2**97
    # the boolean default (u32) and the 18-digit WoPBS set: each plan holds
    # its product with the fewest primes, and no plan does less work
    for p, bits in ((params.DEFAULT_PARAMETERS, 32),
                    (params.PARAM_MESSAGE_2_CARRY_2_KS_PBS, 64),
                    (params.wopbs_params.PARAM_4_BITS_5_BLOCKS, 64),
                    (params.WOPBS_PARAM_MESSAGE_2_CARRY_2_KS_PBS, 64)):
        primes, M = plan(p, bits)
        LJ, G = p.pbs_level * (p.glwe_dimension + 1), p.glwe_dimension + 1
        bound = ntt.product_bound(p.pbs_base_log, LJ, p.polynomial_size,
                                  bits, M)
        assert ntt.holds_product(primes, bound)
        assert not ntt.holds_product(primes[:-1], bound)
        for M2 in ((1, 2) if bits == 64 else (1,)):
            b2 = ntt.product_bound(p.pbs_base_log, LJ, p.polynomial_size,
                                   bits, M2)
            P2 = next(k for k in range(1, 9)
                      if ntt.holds_product(ntt.WIDE_PRIMES[:k], b2))
            assert len(primes) * (LJ + G * M) <= P2 * (LJ + G * M2)
    assert plan(params.DEFAULT_PARAMETERS, 32) == (ntt.WIDE_PRIMES[:2], 1)
    assert plan(params.wopbs_params.PARAM_4_BITS_5_BLOCKS) == (
        ntt.WIDE_PRIMES[:2], 2)
    # the reference's five primes hold every classic product in two planes
    # of a u64 word, never in one
    assert ntt.planes_for(ntt.PRIMES, 23, 1, 2, 2048, 64) == 2
    assert ntt.planes_for(ntt.PRIMES, 6, 3, 3, 512, 32) == 1
    with pytest.raises(ValueError, match="do not hold"):
        ntt.planes_for(ntt.WIDE_PRIMES[:1], 23, 1, 2, 2048, 64)


def test_multi_bit_plan_counts_the_summed_key_words():
    # a multi-bit key word is a sum of 2^gf words (K_0 + sum_{j>=1} X^{d_j}
    # K_j), so its bound is 2^gf times a classic key's: every copied
    # multi-bit set with N <= 2048 still takes four primes and one plane
    from tfhe_tpu_torch.params import multi_bit_params as mbp

    sets = [p for p in mbp.ALL if p.polynomial_size <= 2048]
    assert len(sets) == 4
    for p in sets:
        G, per = p.glwe_dimension + 1, 1 << p.grouping_factor
        args = (p.pbs_base_log, p.pbs_level, G, p.polynomial_size, 64)
        assert ntt.classic_plan(*args, per) == (ntt.WIDE_PRIMES[:4], 1)
        bound = ntt.product_bound(p.pbs_base_log, p.pbs_level * G,
                                  p.polynomial_size, 64, 1, per)
        assert bound == per * ntt.product_bound(
            p.pbs_base_log, p.pbs_level * G, p.polynomial_size, 64, 1)
        assert ntt.holds_product(ntt.WIDE_PRIMES[:4], bound)
        assert not ntt.holds_product(ntt.WIDE_PRIMES[:3], bound)
        # the reference's five primes hold it in two planes, never in one
        assert ntt.planes_for(ntt.PRIMES, *args, per) == 2
    # GROUP_3 (base_log 21, L 1, G 2, N 2048): 8 * 2 * 2048 * 2^20 * 2^63
    assert ntt.product_bound(21, 2, 2048, 64, 1, 8) == 2**98
    # a width at which the factor changes the plan: base_log 10, L 1, G 2,
    # N 512 holds a classic product (2^82 in one plane, 2^51 in two) on two
    # primes in two planes, but 2^gf = 4 words (2^53 in two planes) need
    # three primes there, so one plane on four does fewer transforms
    assert ntt.classic_plan(10, 1, 2, 512, 64) == (ntt.WIDE_PRIMES[:2], 2)
    assert ntt.classic_plan(10, 1, 2, 512, 64, 4) == (ntt.WIDE_PRIMES[:4], 1)
    assert ntt.planes_for(ntt.WIDE_PRIMES[:2], 10, 1, 2, 512, 64) == 2
    with pytest.raises(ValueError, match="do not hold"):
        ntt.planes_for(ntt.WIDE_PRIMES[:2], 10, 1, 2, 512, 64, 4)


@pytest.mark.parametrize("primes", [ntt.PRIMES, ntt.WIDE_PRIMES],
                         ids=["five", "wide"])
def test_64_bit_reduction_lands_below_2p(primes):
    # the core's reduce_u64 of the multi-bit kernels' exact sums: any word
    # below 2^63 (the sums stay below 2^62.9) -> [0, 2p), congruent
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(0, 2**63 - 1, 4096, dtype=np.int64,
                                      endpoint=True))
    x[:6] = torch.tensor([0, 1, 2**32 - 1, 2**32, 2**63 - 1, 2**62 + 7])
    for pi, p in enumerate(primes):
        got = Core(256, pi, primes).reduce_u64(x)
        assert int(got.max()) < 2 * p
        assert torch.equal(got % p, x % p)


def _negacyclic_exact(d, k):
    """d [LJ, N] (|d| < 2^31), k [LJ, O, N] signed int64 -> [O, N] Python
    ints: sum_lj d_lj (x) k_lj, exact (16-bit limbs of k in int64
    convolutions, joined in Python integers)."""
    LJ, O, N = k.shape
    out = [[0] * N for _ in range(O)]
    for lj in range(LJ):
        for o in range(O):
            full = [0] * (2 * N - 1)
            kk = k[lj, o].astype(object)
            for limb in range(4):
                part = (kk >> (16 * limb)) & 0xFFFF if limb < 3 else \
                    kk >> 48  # the top limb keeps the sign
                conv = np.convolve(d[lj].astype(np.int64),
                                   part.astype(np.int64))
                for n, v in enumerate(conv.tolist()):
                    full[n] += v << (16 * limb)
            for n in range(N):
                out[o][n] += full[n] - (full[n + N] if n + N < 2 * N - 1
                                        else 0)
    return out


@pytest.mark.parametrize("extreme", ["all_same_sign", "mixed_signs"])
def test_exact_product_at_its_bound_on_the_classic_primes(extreme):
    # PARAM_MESSAGE_2_CARRY_2_KS_PBS's widths (base_log 23, L 1, G 2,
    # N 2048): digits at +-2^22, key words at 2^64 - 1 and -2^63 (int64 -1
    # and -2^63).  All of one sign, coefficient N - 1 of each output
    # reaches the bound 2^97.  The plain product on the classic key's four
    # primes and one plane, and the kernel's model of it, equal exact
    # integer arithmetic mod 2^64 and the five-prime, two-plane product
    rng = np.random.default_rng(2024)
    bl, L, G, N = 23, 1, 2, 2048
    if extreme == "all_same_sign":
        d = np.full((L * G, N), 2**(bl - 1), np.int64)
        k = np.full((1, L, G, G, N), -2**63, np.int64)
    else:
        d = rng.choice([-2**(bl - 1), 2**(bl - 1)], (L * G, N))
        k = rng.choice(np.array([-1, -2**63], np.int64), (1, L, G, G, N))
    exact = _negacyclic_exact(d, k[0].reshape(L * G, G, N))
    if extreme == "all_same_sign":
        assert max(abs(v) for row in exact for v in row) == 2**97
    want = torch.tensor([[v % 2**64 - (2**64 if v % 2**64 >= 2**63 else 0)
                          for v in row] for row in exact], dtype=torch.int64)
    digits = torch.from_numpy(d.astype(np.int32)).reshape(1, L, G, N)
    acc = torch.zeros((1, G, N), dtype=torch.int64)
    raw = torch.from_numpy(k)
    wide = core.prepare_bsk_cuda(raw, bl)
    five = core.prepare_bsk_cuda(raw, bl, primes=ntt.PRIMES)
    assert (wide.primes, wide.planes) == (ntt.WIDE_PRIMES[:4], 1)
    assert (five.primes, five.planes) == (ntt.PRIMES, 2)
    got = fused_pbs.external_product_crt_plain(digits, wide.kspec[0], acc,
                                               primes=wide.primes)
    assert torch.equal(got[0], want)
    assert torch.equal(got, fused_pbs.external_product_crt_plain(
        digits, five.kspec[0], acc, primes=five.primes))
    assert torch.equal(got, model_external_product(
        digits, wide.kspec[0], wide.kshoup[0], acc, 64, wide.primes))
