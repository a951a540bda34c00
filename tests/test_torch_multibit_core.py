"""A plain PyTorch model of K9 `multibit_step` as it runs on the
register-resident NTT core (tfhe_tpu_torch/ops/csrc/multibit_core.cuh),
and of K8's two stages, `multibit_combine` (multibit_kernels.cuh) and
`multibit_external_product` (K9's kernel with one subset and the key per
ciphertext), checked word for word on the CPU.

The model does what the kernel's threads do: the signed digits of the
accumulator itself, each made at its own word (`decompose_word` of
tests/test_torch_ntt_core_steps.py); each prime's forward transforms as the
core runs them (the `Core` model of tests/test_torch_ntt_core.py), left at
the words of shift 0, where thread tid holds the spectral words
n = tid * 8 + k, then reduced into [0, 2p); the subset MAC: for subset
j >= 1 the digit spectra times the monomial psi^(d_j e(n)), taken as the
gather psi^(d_j e(tid * 8)) (with its Shoup companion) and, for k > 0, the
8th root of unity w^m, w = psi^(N/4), m = d_j bitrev3(k) mod 8, as a
product by w^(m mod 4) unless that is 1 and a negation 2p - y for m >= 4,
each product a lazy Shoup product on uint32 words; the products with the
canonical key words summed exactly (in 64 bits on the card); one
reduction of each sum into [0, 2p) (the core's `reduce_u64`); the inverse
transforms; and the explicit CRT from zero.  K8's external product is the same model with one
subset, no monomial, and each ciphertext's own combined key.  K8's combine
is modelled per thread: a thread owns one ciphertext's 8 words n0 ... n0 +
7 of each key row (n0 a multiple of 8), gathers psi^(d_j e(n0)) with its
companion once per subset, makes the four values psi^(d_j e(n0)) w^s
(s < 4), picks and signs one per word as above, and sums the products
with the canonical key words exactly, reduced canonical once.  Every model
runs on the key's prime set: the reference's five primes below 2^17 in two
planes, or the set `ntt.classic_plan` gives the widths (four primes below
2^26.83, one plane).  Checked: the split of e(n) the kernel relies on, for
every N the core takes and both sets; the models against
`multibit_step_plain`, `multibit_combine_plain` and
`multibit_external_product_plain` at N = 256 and 512, gf = 2 and 3, on
both sets, and at the sums' extremes (every key word p - 1, every
monomial p - 1; 16 subsets at L*G = 18); and, through a whole multi-bit
blind rotation whose
every group step is the model (both schedules), against the reference's
`fused_multibit_rotate_scan1` and `fused_multibit_rotate_scan`
(tfhe_tpu/ops/fused_multibit.py:508, :702), interpreted on the CPU as
tests/test_fused_multibit.py runs them."""

import numpy as np
import pytest
import torch

from tfhe_tpu.ops.fused_multibit import (multi_bit_blind_rotate_fused,
                                         prepare_multi_bit_bsk_fused)

from tfhe_tpu_torch import core
from tfhe_tpu_torch.ops import fused_multibit, ntt
from tfhe_tpu_torch.ops.torus import to_numpy, to_tensor
from test_torch_ntt_core import M32, Core, elem, explicit_crt, shoup_lazy
from test_torch_ntt_core_steps import decompose_word

BITREV3 = [0, 4, 2, 6, 1, 5, 3, 7]


def root_power(y, m, pw, pwsh, N, p):
    """y [B, ...] words below 2^32 times w^m, m [B] in [0, 8): a lazy Shoup
    product by w^(m mod 4) (w = psi^(N/4)) unless that is 1, then 2p - y
    for m >= 4, as the kernels compute it."""
    shape = (-1,) + (1,) * (y.dim() - 1)
    m = m.reshape(shape)
    r = (m & 3) * (N // 4)
    y = torch.where((m & 3) > 0, shoup_lazy(y, pw[r], pwsh[r], p), y)
    return torch.where(m >= 4, 2 * p - y, y)


def model_multibit_step(acc, d, kspec, base_log, levels, combined=False,
                        primes=ntt.PRIMES):
    """K9 as the kernel computes it: acc [B, G, N] int64, d [B, 2^gf] int32,
    kspec [2^gf, P, LJ, G, M, N] over `primes` -> the new accumulator [B,
    G, N] int64.  With `combined`, K8's external product on the same
    kernel: kspec the combined keys [B, P, LJ, G, M, N], one subset, no
    monomial (d is not read)."""
    B, G, N = acc.shape
    per, P, LJ, O, M, _ = kspec.shape
    assert P == len(primes)
    per = 1 if combined else per
    T = N // ntt.PASS_RADIX
    dig = decompose_word(to_numpy(acc).astype(np.uint64), base_log, levels,
                         64)  # [L, B, G, N], level-major
    digits = torch.from_numpy(np.ascontiguousarray(
        dig.transpose(1, 0, 2, 3))).reshape(B, LJ, N)
    mono = ntt.monomial_tables_for(N, "cpu", primes)
    e0 = mono.exponents.to(torch.int64)[torch.arange(T) * ntt.PASS_RADIX]
    dj = None if combined else d.to(torch.int64)
    pos = elem(T, 0)
    xcrt = ntt.tables_for(N, "cpu", primes).xcrt
    res = torch.empty((B, O, M, P, N), dtype=torch.int64)
    for pi in range(P):
        c = Core(N, pi, primes)
        pw = mono.powers[pi, 0].to(torch.int64) & M32
        pwsh = mono.powers[pi, 1].to(torch.int64) & M32
        spec = shoup_lazy(c.forward(c.digit_mod(digits)), 1, c.one_sh,
                          c.p)  # [B, LJ, T, r] in [0, 2p)
        o = torch.zeros((B, O * M, T, ntt.PASS_RADIX), dtype=torch.int64)
        for j in range(per):
            dm = spec
            if j > 0:
                t = (dj[:, j, None] * e0) & (2 * N - 1)  # [B, T]
                dm = shoup_lazy(spec, pw[t][:, None, :, None],
                                pwsh[t][:, None, :, None], c.p).clone()
                for k in range(1, ntt.PASS_RADIX):
                    # w^m, m = d_j bitrev3(k) mod 8
                    dm[..., k] = root_power(dm[..., k],
                                            (dj[:, j] * BITREV3[k]) & 7,
                                            pw, pwsh, N, c.p)
            if combined:  # each ciphertext's own key [B, LJ, OM, T, r]
                key = kspec[:, pi].to(torch.int64).reshape(
                    B, LJ, O * M, N)[..., pos]
            else:
                key = kspec[j, pi].to(torch.int64).reshape(
                    LJ, O * M, N)[..., pos][None]
            o = o + (dm[:, :, None] * key).sum(dim=1)
        # the kernel's 64-bit sums: 2^gf LJ <= 288 terms (K8: LJ <= 18),
        # each a word at most 2p times one below p
        assert int(o.max()) <= (1 if combined else per) * LJ * 2 * c.p * (
            c.p - 1) < 1 << 63
        x = c.reduce_u64(o)  # [0, 2p)
        out = c.canonical(c.inverse(x), int(xcrt[pi, 1]), int(xcrt[pi, 2]))
        res[:, :, :, pi] = out.reshape(B, O, M, N)
    return explicit_crt(res, torch.zeros_like(acc), 64, primes)


def model_combine(d, kspec, primes=ntt.PRIMES):
    """K8's combine as its threads compute it: d [B, 2^gf] int32, kspec
    [2^gf, P, LJ, O, M, N] canonical over `primes` -> combined [B, P, LJ,
    O, M, N] int32.  A thread owns one ciphertext's words n0 ... n0 + 7 (n0 a
    multiple of 8) of every key row; per subset j >= 1 it gathers
    psi^(d_j e(n0)) and its companion, makes the four canonical values
    V_s = psi^(d_j e(n0)) w^s (s < 4) by Shoup products, takes mon_j(n0 +
    k) = V_(m mod 4), negated for m >= 4 (m = d_j bitrev3(k) mod 8), and
    sums K_0 + sum_j mon_j K_j exactly (64 bits on the card), reduced
    canonical once (the core's `reduce_u64`, then a subtraction of p).
    The kernel's tiles of rows only schedule this."""
    per, P, LJ, O, M, N = kspec.shape
    B, T, R = d.shape[0], N // ntt.PASS_RADIX, LJ * O * M
    mono = ntt.monomial_tables_for(N, "cpu", primes)
    e0 = mono.exponents.to(torch.int64)[torch.arange(T) * ntt.PASS_RADIX]
    dj = d.to(torch.int64)
    key = (kspec.to(torch.int64) & M32).reshape(per, P, R, T,
                                                ntt.PASS_RADIX)
    rows = torch.arange(B)
    out = torch.empty((B, P, R, T, ntt.PASS_RADIX), dtype=torch.int64)
    for pi, p in enumerate(primes):
        pw = mono.powers[pi, 0].to(torch.int64) & M32
        pwsh = mono.powers[pi, 1].to(torch.int64) & M32
        o = key[0, pi].expand(B, -1, -1, -1).clone()
        for j in range(1, per):
            t = (dj[:, j, None] * e0) & (2 * N - 1)  # [B, T]
            v0, v0sh = pw[t], pwsh[t]
            vals = [v0]
            for s in range(1, 4):  # w^s times psi^t, canonical
                y = shoup_lazy(int(pw[s * N // 4]), v0, v0sh, p)
                vals.append(torch.where(y >= p, y - p, y))
            vals = torch.stack(vals)  # [4, B, T]
            for k in range(ntt.PASS_RADIX):
                m = (dj[:, j] * BITREV3[k]) & 7  # [B]
                v = vals[m & 3, rows]
                mon = torch.where((m >= 4)[:, None], p - v, v)
                o[..., k] += key[j, pi][None, ..., k] * mon[:, None, :]
        # K_0 + 2^gf - 1 products of canonical words
        assert int(o.max()) <= (p - 1) + (per - 1) * (p - 1)**2 < 1 << 58
        r = Core(N, pi, primes).reduce_u64(o)  # [0, 2p)
        out[:, pi] = torch.where(r >= p, r - p, r)
    return out.reshape(B, P, LJ, O, M, N).to(torch.int32)


# the key's prime sets: the reference's five primes (two planes), and the
# one the widths give (`ntt.classic_plan` for 2^gf summed words: four wide
# primes and one plane, or at base_log 8, L 2 two primes and two planes)
KEY_SETS = [ntt.PRIMES, None]
KEY_IDS = ["five", "plan"]


def _prepare(raw, bl, gf, primes):
    key = core.prepare_multi_bit_bsk_cuda(raw, bl, gf, primes)
    _, per, L, G, _, N = raw.shape
    if primes is None:
        assert (key.primes, key.planes) == ntt.classic_plan(bl, L, G, N, 64,
                                                            per)
        assert key.primes == ntt.WIDE_PRIMES[:len(key.primes)]
    else:
        assert (key.primes, key.planes) == (ntt.PRIMES, 2)
    return key


@pytest.mark.parametrize("primes", [ntt.PRIMES, ntt.WIDE_PRIMES],
                         ids=["five", "wide"])
@pytest.mark.parametrize("N", [256, 512, 1024, 2048])
def test_exponents_split_at_a_threads_first_word(N, primes):
    # e(tid * 8 + k) = e(tid * 8) + bitrev3(k) N/4 mod 2N, and psi^(N/4)
    # is an 8th root of unity, for every prime of either set
    mono = ntt.monomial_tables_for(N, "cpu", primes)
    e = mono.exponents.to(torch.int64).reshape(-1, ntt.PASS_RADIX)
    want = torch.tensor(BITREV3) * (N // 4)
    assert torch.equal((e - e[:, :1]) % (2 * N), want.expand_as(e))
    assert torch.equal(mono.exponents,
                       ntt.monomial_tables_for(N, "cpu").exponents)
    for pi, p in enumerate(primes):
        w = int(mono.powers[pi, 0, N // 4]) & M32
        assert pow(w, 4, int(p)) == int(p) - 1


# (gf, N, L, base_log, G): the tests/test_fused_multibit.py cases at
# N = 256 and the GROUP_2 / GROUP_3 sets' N = 512 width (G = 4)
STEP_CASES = [(2, 256, 2, 8, 2), (3, 256, 1, 15, 2), (2, 512, 1, 18, 4),
              (3, 512, 1, 18, 4)]
STEP_IDS = ["gf2N256L2", "gf3N256L1", "gf2N512G4", "gf3N512G4"]


@pytest.mark.parametrize("primes", KEY_SETS, ids=KEY_IDS)
@pytest.mark.parametrize("case", STEP_CASES, ids=STEP_IDS)
def test_step_model_equals_plain(case, primes):
    gf, N, L, bl, G = case
    rng = np.random.default_rng(list(case))
    key = _prepare(to_tensor(rng.integers(
        0, 1 << 64, (1, 1 << gf, L, G, G, N), dtype=np.uint64), "cpu"), bl, gf,
        primes)
    acc = to_tensor(rng.integers(0, 1 << 64, (3, G, N), dtype=np.uint64),
                    "cpu")
    d = torch.from_numpy(rng.integers(0, 2 * N, (3, 1 << gf))
                         .astype(np.int32))
    ks, ps = key.kspec[0], key.primes
    got = model_multibit_step(acc, d, ks, bl, L, primes=ps)
    assert torch.equal(got, fused_multibit.multibit_step_plain(
        acc, d, ks, bl, L, ps))
    assert torch.equal(got, fused_multibit.multibit_external_product_plain(
        acc, fused_multibit.multibit_combine_plain(d, ks, ps), bl, L, ps))


@pytest.mark.parametrize("primes", KEY_SETS, ids=KEY_IDS)
@pytest.mark.parametrize("case", STEP_CASES, ids=STEP_IDS)
def test_scan3_stage_models_equal_plain(case, primes):
    # K8's combine thread and its external product (K9's kernel at one
    # subset, the key per ciphertext), each against its plain twin
    gf, N, L, bl, G = case
    rng = np.random.default_rng([13] + list(case))
    key = _prepare(to_tensor(rng.integers(
        0, 1 << 64, (1, 1 << gf, L, G, G, N), dtype=np.uint64), "cpu"), bl, gf,
        primes)
    acc = to_tensor(rng.integers(0, 1 << 64, (3, G, N), dtype=np.uint64),
                    "cpu")
    d = torch.from_numpy(rng.integers(0, 2 * N, (3, 1 << gf))
                         .astype(np.int32))
    d[0] = torch.tensor([0, N, 2 * N - 1, 1] * (1 << gf))[:1 << gf]
    ks, ps = key.kspec[0], key.primes
    comb = model_combine(d, ks, ps)
    assert torch.equal(comb, fused_multibit.multibit_combine_plain(d, ks, ps))
    got = model_multibit_step(acc, None, comb, bl, L, combined=True,
                              primes=ps)
    assert torch.equal(got, fused_multibit.multibit_external_product_plain(
        acc, comb, bl, L, ps))


def full_key(primes, per, LJ, G, M, N):
    """kspec [per, P, LJ, G, M, N] with every word p - 1, the largest
    canonical residue of its prime."""
    p = torch.tensor(primes, dtype=torch.int64).view(1, -1, 1, 1, 1, 1)
    return (p - 1).expand(per, -1, LJ, G, M, N).to(torch.int32).contiguous()


@pytest.mark.parametrize("primes", [ntt.PRIMES, ntt.WIDE_PRIMES[:4]],
                         ids=["five", "wide"])
def test_models_at_the_sums_extremes(primes):
    # the combine: every key word p - 1 and every monomial p - 1 (d_j = N:
    # X^N = -1 at every spectral word), so each of its sums reaches K_0 +
    # 7 (p - 1)^2; K9's MAC at 16 subsets and L*G = 18, 288 terms a sum,
    # every key word p - 1; K8's external product on the combined keys
    M = 2 if primes == ntt.PRIMES else 1
    rng = np.random.default_rng(17)
    N, G = 256, 2
    ks = full_key(primes, 8, 2, G, M, N)
    d = torch.full((3, 8), N, dtype=torch.int32)
    d[1, 1:] = torch.from_numpy(rng.integers(0, 2 * N, 7).astype(np.int32))
    mon = ntt.monomial_spectra(d, N, primes)
    assert torch.equal(mon[0, 1:], (torch.tensor(primes) - 1).view(1, -1, 1)
                       .expand(7, -1, N))
    comb = model_combine(d, ks, primes)
    assert torch.equal(comb, fused_multibit.multibit_combine_plain(
        d, ks, primes))
    acc = to_tensor(rng.integers(0, 1 << 64, (3, G, N), dtype=np.uint64),
                    "cpu")
    assert torch.equal(
        model_multibit_step(acc, None, comb, 15, 1, combined=True,
                            primes=primes),
        fused_multibit.multibit_external_product_plain(acc, comb, 15, 1,
                                                       primes))
    L, bl = 9, 7  # L*G = 18
    ks = full_key(primes, 16, L * G, G, M, N)
    d = torch.from_numpy(rng.integers(0, 2 * N, (3, 16)).astype(np.int32))
    acc = to_tensor(rng.integers(0, 1 << 64, (3, G, N), dtype=np.uint64),
                    "cpu")
    assert torch.equal(
        model_multibit_step(acc, d, ks, bl, L, primes=primes),
        fused_multibit.multibit_step_plain(acc, d, ks, bl, L, primes))


# (gf, N, L, base_log, groups, B): tests/test_fused_multibit.py's cases
ROTATION_CASES = [(3, 256, 1, 15, 4, 4), (2, 256, 2, 8, 3, 3)]


def rotate_with_the_models(case, mode, monkeypatch):
    """The port's rotation in `mode` with every kernel replaced by its
    model, and the reference's Pallas rotation in the same schedule,
    interpreted; and the number of group steps the models ran."""
    gf, N, L, bl, groups, B = case
    G = 2
    rng = np.random.default_rng(11)
    mbsk = rng.integers(0, 1 << 64, (groups, 1 << gf, L, G, G, N),
                        dtype=np.uint64)
    lwe = rng.integers(0, 1 << 64, (B, groups * gf + 1), dtype=np.uint64)
    lut = rng.integers(0, 1 << 64, (B, G, N), dtype=np.uint64)
    key = _prepare(to_tensor(mbsk, "cpu"), bl, gf, None)
    steps = []

    def model(acc, d, kspec, base_log, levels, *, primes):
        steps.append(d.shape)
        return model_multibit_step(acc, d, kspec, base_log, levels,
                                   primes=primes)

    def combine(d, kspec, *, primes):
        steps.append(d.shape)
        return model_combine(d, kspec, primes)

    def product(acc, combined, base_log, levels, *, primes):
        return model_multibit_step(acc, None, combined, base_log, levels,
                                   combined=True, primes=primes)

    monkeypatch.setattr(fused_multibit, "multibit_step", model)
    monkeypatch.setattr(fused_multibit, "multibit_combine", combine)
    monkeypatch.setattr(fused_multibit, "multibit_external_product", product)
    got = core.multi_bit_blind_rotate(key, to_tensor(lut, "cpu"),
                                      to_tensor(lwe, "cpu"), mode=mode)
    monkeypatch.setenv("TFHE_TPU_MULTIBIT_MODE", mode)
    want = np.asarray(multi_bit_blind_rotate_fused(
        prepare_multi_bit_bsk_fused(mbsk, bl, gf), lut, lwe))
    return to_numpy(got), want, len(steps)


@pytest.mark.parametrize("case", ROTATION_CASES, ids=["gf3L1", "gf2L2"])
def test_rotation_with_the_model_equals_the_reference(case, monkeypatch):
    got, want, steps = rotate_with_the_models(case, "scan1", monkeypatch)
    assert steps == case[4]
    assert np.array_equal(got, want)


@pytest.mark.parametrize("case", ROTATION_CASES, ids=["gf3L1", "gf2L2"])
def test_scan3_rotation_with_the_models_equals_the_reference(case,
                                                             monkeypatch):
    # K8's schedule: the combine's model, then the external product's
    got, want, steps = rotate_with_the_models(case, "scan3", monkeypatch)
    assert steps == case[4]
    assert np.array_equal(got, want)
