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
    """One prime's tables as the kernel reads them."""

    def __init__(self, N, prime):
        tab = ntt.pass_tables_for(N, "cpu")[prime].to(torch.int64) & M32
        self.N, self.T = N, N // r
        self.p, self.p2, self.one_sh, self.off = (int(v) for v in tab[:4])
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

    def canonical(self, x, w=1, wsh=None):
        wsh = self.one_sh if wsh is None else wsh
        y = shoup_lazy(x, w, wsh, self.p)
        return umin(y, y - self.p)


def explicit_crt(c, acc, bits):
    """c [B, O, M, P, N] (c_i = r_i N^-1 (Q/p_i)^-1 mod p_i), acc [B, O, N]
    -> acc + the product, as the kernel's `crt_word` computes each word:
    per plane, sum_i c_i Q/p_i - round(sum_i c_i t_i / 2^28) Q, shifted by
    32 m bits, with 64-bit (and, for the fraction, 32-bit) wrap."""
    x = ntt.tables_for(c.shape[-1], "cpu").xcrt  # [P, 6] int64
    c = c.to(torch.int64)
    total = acc.clone()
    for m in range(c.shape[2]):
        cm = c[:, :, m]  # [B, O, P, N]
        s = (cm * x[:, 3].view(1, 1, -1, 1)).sum(dim=2)  # wraps mod 2^64
        frac = (cm * x[:, 4].view(1, 1, -1, 1)).sum(dim=2) & M32
        k = (frac + (1 << (ntt.XCRT_FRAC_BITS - 1))) >> ntt.XCRT_FRAC_BITS
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


def model_external_product(digits, kspec, kshoup, acc, bits):
    """K2 as the kernel computes it: per prime (a CTA of the cluster),
    `prime_product`, then c_i = r_i w_i mod p_i; then the explicit CRT over
    the primes' values."""
    B, L, G, N = digits.shape
    P, LJ, O, M, _ = kspec.shape
    xcrt = ntt.tables_for(N, "cpu").xcrt
    res = torch.empty((B, O, M, P, N), dtype=torch.int64)
    for pi in range(P):
        c = Core(N, pi)
        out = prime_product(c, digits, kspec[pi], kshoup[pi])  # [B, OM, N]
        res[:, :, :, pi] = c.canonical(out, int(xcrt[pi, 1]),
                                       int(xcrt[pi, 2])).reshape(B, O, M, N)
    return explicit_crt(res, acc, bits)


@pytest.mark.parametrize("N", SIZES)
def test_transforms_equal_the_plain_ntt_for_every_prime(N):
    rng = np.random.default_rng(N)
    # signed digits of every magnitude the decompositions give, and the
    # int32 extremes
    d = torch.from_numpy(rng.integers(-2**22, 2**22, (3, N), endpoint=True)
                         .astype(np.int32))
    d[0, :4] = torch.tensor([-2**31, 2**31 - 1, 0, -1], dtype=torch.int32)
    want = ntt.forward_ntt(d.to(torch.int64))  # [3, P, N]
    spec = torch.from_numpy(rng.integers(0, 2**31, (3, len(ntt.PRIMES), N)))
    spec = spec % ntt.tables_for(N, "cpu").primes[:, None]
    want_inv = ntt.inverse_ntt(spec)
    pos = elem(N // r, 0).reshape(-1)
    for pi in range(len(ntt.PRIMES)):
        c = Core(N, pi)
        got = torch.empty((3, N), dtype=torch.int64)
        got[:, pos] = c.canonical(c.forward(c.digit_mod(d))).reshape(3, N)
        assert torch.equal(got, want[:, pi])
        x = spec[:, pi, pos].reshape(3, N // r, r)
        ninv = int(ntt.tables_for(N, "cpu").n_inv[pi])
        out = c.canonical(c.inverse(x), ninv, (ninv << 32) // c.p)
        assert torch.equal(out, want_inv[:, pi])


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
        model_external_product(dig, key.kspec[0], key.kshoup[0], acc, bits),
        fused_pbs.external_product_crt_plain(dig, key.kspec[0], acc, bits))

    # a blind rotation in scan2 whose every K2 step is the model, against
    # the reference's scan2 Pallas kernels in interpret mode
    def model_k2(digits, kspec, kshoup, acc, bits=64):
        return model_external_product(digits, kspec, kshoup, acc, bits)

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


@pytest.mark.parametrize("N", SIZES)
def test_pass_tables_hold_the_twiddles_of_the_passes(N):
    # every twiddle a pass reads is psi^bitrev / psi^-bitrev at the index of
    # its butterfly group, and the companions are Shoup's
    tab = ntt.tables_for(N, "cpu")
    for pi in (0, len(ntt.PRIMES) - 1):
        c = Core(N, pi)
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
