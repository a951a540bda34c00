"""Exact negacyclic NTTs over five primes, and CRT back to the u64 torus.

Port of the arithmetic in `tfhe_tpu/ops/ntt.py` (`PRIMES` at :40,
`crt_to_u64_centered` at :496).  The TPU version is a four-step transform
made of int8 matmuls; here the plain version is the textbook radix-2 one in
int64 torch ops, and the CUDA kernel (`csrc/pbs_kernels.cuh`) runs the same
butterflies with 32-bit Shoup products.  Any exact method gives the same
convolution, so spectra never leave this module's layout: they are stored in
bit-reversed order, and only products of spectra are compared with the
reference.

Forward: Cooley-Tukey butterflies with the powers of psi (a primitive 2N-th
root of unity) in bit-reversed order, which folds the negacyclic twist into
the stages.  Inverse: Gentleman-Sande butterflies with the inverse powers,
then a scale by N^-1 (Longa & Naehrig, "Speeding up the Number Theoretic
Transform for Faster Ideal Lattice-Based Cryptography", 2016, Alg. 1-2).

Residues are canonical, in [0, p).  p < 2^17, so a product of two residues
fits easily in int64 and in the 32-bit Shoup form the kernel uses.

Position i of a forward spectrum is the polynomial's value at psi^e(i) for
an odd exponent e(i), so the spectrum of the monomial X^d is
psi^(d * e(i) mod 2N) at position i: `monomial_spectra` gathers it from a
table of the 2N powers of psi, which the multi-bit blind rotation uses in
place of a transform.  e(i) is read off the transform itself
(`_host_monomial_tables`), so it holds for this module's layout only.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from . import u128

# NTT-friendly primes == 1 mod 4096, so 2N-th roots exist for N <= 2048.
PRIMES: tuple[int, ...] = (12289, 40961, 61441, 65537, 86017)
CRT_MODULUS = int(np.prod([int(p) for p in PRIMES], dtype=object))


def _find_generator(p: int) -> int:
    n, factors, d = p - 1, [], 2
    while d * d <= n:
        if n % d == 0:
            factors.append(d)
            while n % d == 0:
                n //= d
        d += 1
    if n > 1:
        factors.append(n)
    for g in range(2, p):
        if all(pow(g, (p - 1) // f, p) != 1 for f in factors):
            return g
    raise ValueError(f"no generator for {p}")


def _bitrev(N: int) -> np.ndarray:
    logn = N.bit_length() - 1
    idx = np.arange(N)
    rev = np.zeros(N, dtype=np.int64)
    for b in range(logn):
        rev |= ((idx >> b) & 1) << (logn - 1 - b)
    return rev


@functools.cache
def _host_tables(N: int):
    """Per prime: psi^bitrev(k), psi^-bitrev(k) (int64 [P, N]) and N^-1."""
    if N & (N - 1) or N < 2:
        raise ValueError(f"polynomial size {N} is not a power of two")
    rev = _bitrev(N)
    fwd, inv, ninv = [], [], []
    for p in PRIMES:
        if (p - 1) % (2 * N):
            raise ValueError(f"{p} has no primitive {2 * N}-th root")
        psi = pow(_find_generator(p), (p - 1) // (2 * N), p)
        psi_inv = pow(psi, p - 2, p)
        fwd.append([pow(psi, int(r), p) for r in rev])
        inv.append([pow(psi_inv, int(r), p) for r in rev])
        ninv.append(pow(N, p - 2, p))
    return (np.array(fwd, np.int64), np.array(inv, np.int64),
            np.array(ninv, np.int64))


def _shoup(w: np.ndarray, p) -> np.ndarray:
    """floor(w * 2^32 / p) for 0 <= w < p (the kernel's Shoup companion)."""
    return (w.astype(object) * (1 << 32) // p).astype(np.uint64)


@dataclass(frozen=True)
class NttTables:
    """Device copies of the twiddles, for the plain version and the kernel.

    primes [P]; psi_rev / psi_inv_rev [P, N]; n_inv [P] (all int64);
    kernel [P, 5, N] int32 bit patterns of uint32: psi_rev, its Shoup
    companion, psi_inv_rev, its companion, and (N^-1, companion, p,
    floor(2^34 / p)) at the start of row 4 (the last is the Barrett
    constant of a product of two residues);  crt [P, 2P + 4] int64,
    Garner's constants for prime i with Q_j = p_0...p_{j-1}: Q_j mod p_i
    (j < P), their Shoup companions, Q_i^-1 mod p_i, its companion, p_i,
    Q_i mod 2^64 (as int64 bits);  xcrt [P, XCRT_WIDTH] int64, the
    explicit CRT's constants (`_explicit_crt_host`)."""

    primes: torch.Tensor
    psi_rev: torch.Tensor
    psi_inv_rev: torch.Tensor
    n_inv: torch.Tensor
    kernel: torch.Tensor
    crt: torch.Tensor
    xcrt: torch.Tensor


def _as_i32_bits(u: np.ndarray) -> np.ndarray:
    return u.astype(np.uint64).astype(np.uint32).view(np.int32)


@functools.cache
def _garner_host() -> np.ndarray:
    P = len(PRIMES)
    out = np.zeros((P, 2 * P + 4), dtype=np.int64)
    for i, p in enumerate(PRIMES):
        q = 1
        for j in range(P):
            out[i, j] = q % p
            out[i, P + j] = _shoup(np.array([q % p]), p)[0]
            q *= PRIMES[j]
        q_i = int(np.prod([int(v) for v in PRIMES[:i]], dtype=object))
        inv = pow(q_i % p, p - 2, p)
        out[i, 2 * P] = inv
        out[i, 2 * P + 1] = _shoup(np.array([inv]), p)[0]
        out[i, 2 * P + 2] = p
        v = q_i % (1 << 64)
        out[i, 2 * P + 3] = v - (1 << 64) if v >= 1 << 63 else v
    return out


# the explicit CRT's fraction sum_i c_i / p_i, as a u32 fixed-point number
# with XCRT_FRAC_BITS fraction bits
XCRT_FRAC_BITS = 28
XCRT_WIDTH = 6


def _int64_bits(v: int) -> int:
    v %= 1 << 64
    return v - (1 << 64) if v >= 1 << 63 else v


@functools.cache
def _explicit_crt_host(N: int) -> np.ndarray:
    """Constants of the explicit CRT (the single-CTA kernels', after the
    reference's `_crt_accumulate`, tfhe_tpu/ops/fused_pbs.py:709), per prime
    i with Q = prod p and Q_i = Q / p_i: p_i; w_i = N^-1 (Q_i)^-1 mod p_i
    and its Shoup companion; Q_i mod 2^64; T_i = round(2^28 / p_i); Q mod
    2^64 (the last two as int64 bits).

    For the unscaled inverse transform r_i of a convolution x,
    c_i = r_i w_i mod p_i gives x = sum_i c_i Q_i - k Q with
    k = round(sum_i c_i / p_i).  The kernel sums c_i T_i in a u32 (below
    P (2^28 + 2^16) < 2^32 for P <= 8) and takes k = (sum + 2^27) >> 28:
    each term is off by at most c_i / 2 < 2^16 units of 2^-28, so the sum
    is within P 2^-12 of sum_i c_i / p_i, which is within |x| / Q of the
    integer k.  For |x| < 2^67 and these five primes (Q > 2^77) the two
    errors add to below 0.003, far from the 1/2 at which k could round
    the wrong way: x is exact.  N = 1 gives the constants for residues
    already scaled by N^-1 (`residue_crt_for`)."""
    P = len(PRIMES)
    Q = int(CRT_MODULUS)
    out = np.zeros((P, XCRT_WIDTH), np.int64)
    for i, p in enumerate(PRIMES):
        q_i = Q // p
        w = pow(N, p - 2, p) * pow(q_i % p, p - 2, p) % p
        out[i] = (p, w, (w << 32) // p, _int64_bits(q_i),
                  ((1 << XCRT_FRAC_BITS) + p // 2) // p, _int64_bits(Q))
    return out


# The register-resident NTT core (csrc/ntt_core.cuh): a thread holds
# PASS_RADIX = 2^PASS_LOG_RADIX words of a polynomial and runs up to
# PASS_LOG_RADIX butterfly stages on them in registers (a pass); shared
# memory only moves words between passes.  In the layout of shift a, thread
# tid holds the words j(k) = (tid >> a) << (a + PASS_LOG_RADIX) | k << a |
# (tid & (2^a - 1)), k in [0, PASS_RADIX): the butterflies of the stages with
# half-distance 2^a ... 2^(a + PASS_LOG_RADIX - 1) pair words of one thread.
PASS_LOG_RADIX = 3
PASS_RADIX = 1 << PASS_LOG_RADIX
PASS_RECORD = 2 * PASS_RADIX  # twiddles, then their Shoup companions
PASS_HEADER = 8  # p, 2p, floor(2^32 / p), p - 2^31 mod p, N^-1, its companion,
#                 then zeros


def pass_plan(N: int) -> tuple[int, list[int]]:
    """(s0, shifts): the forward transform's passes, shift a of each, in
    order; the first pass runs its first s0 stages only (the half-distances
    N/2 ... N/2^s0), every other pass all PASS_LOG_RADIX.  The last forward
    pass has shift 0, so it holds PASS_RADIX adjacent spectral words.  The
    inverse runs the same passes in reverse, the last one its last s0
    stages."""
    log_n = N.bit_length() - 1
    R = PASS_LOG_RADIX
    passes = -(-log_n // R)
    s0 = log_n - R * (passes - 1)
    return s0, [log_n - R] + [log_n - s0 - q * R for q in range(1, passes)]


def _pass_records(N: int, psi: np.ndarray, p: int, inverse: bool
                  ) -> np.ndarray:
    """One direction's records for one prime, pass after pass (the inverse's
    in its own order): for each group h = tid >> a, PASS_RADIX twiddles and
    PASS_RADIX companions.  Forward (Cooley-Tukey) stage u of a pass pairs
    k with k + r/2^(u+1) and reads entry 2^u - 1 + (k >> (R - u)), which is
    psi^bitrev[2^(log N - a - R + u) + (h << u) + c]; inverse
    (Gentleman-Sande) stage u pairs k with k + 2^u and reads entry
    r - r/2^u + (k >> (u + 1)), psi^-bitrev[2^(log N - a - u - 1)
    + (h << (R - 1 - u)) + c].  Entries of stages a pass does not run, and
    the last entry, are 0."""
    log_n = N.bit_length() - 1
    R, r = PASS_LOG_RADIX, PASS_RADIX
    s0, shifts = pass_plan(N)
    order = shifts[::-1] if inverse else shifts
    out = []
    for q, a in enumerate(order):
        first = q == 0 and not inverse
        last = q == len(order) - 1 and inverse
        groups = N >> (a + R)
        tw = np.zeros((groups, r), np.int64)
        for u in range(R):
            if (first and u >= s0) or (last and u < R - s0):
                continue
            h = np.arange(groups)[:, None]
            if inverse:
                c = np.arange(r >> (u + 1))[None, :]
                tw[h, r - (r >> u) + c] = psi[
                    (1 << (log_n - a - u - 1)) + (h << (R - 1 - u)) + c]
            else:
                c = np.arange(1 << u)[None, :]
                tw[h, (1 << u) - 1 + c] = psi[
                    (1 << (log_n - a - R + u)) + (h << u) + c]
        out.append(np.concatenate([tw, _shoup(tw, p).astype(np.int64)], 1))
    return np.concatenate(out).reshape(-1)


@functools.cache
def _host_pass_tables(N: int) -> np.ndarray:
    """[P, PASS_HEADER + 2 W] int64 (uint32 values): per prime the header
    (p, 2p, floor(2^32 / p), p - 2^31 mod p, N^-1 mod p, its Shoup
    companion, 0, 0), then the forward records, then the inverse records
    (W words each)."""
    if not 256 <= N <= 2048 or N & (N - 1):
        raise ValueError(f"the NTT core takes N in 256 ... 2048, not {N}")
    fwd, inv, ninv = _host_tables(N)
    rows = []
    for i, p in enumerate(PRIMES):
        n_inv = int(ninv[i])
        head = np.array([p, 2 * p, (1 << 32) // p, p - (1 << 31) % p, n_inv,
                         (n_inv << 32) // p, 0, 0], np.int64)
        rows.append(np.concatenate([head, _pass_records(N, fwd[i], p, False),
                                    _pass_records(N, inv[i], p, True)]))
    return np.stack(rows)


@functools.cache
def ntt_tables(N: int, device: str) -> NttTables:
    fwd, inv, ninv = _host_tables(N)
    P = len(PRIMES)
    primes = np.array(PRIMES, np.int64)
    kern = np.zeros((P, 5, N), np.int32)
    for i, p in enumerate(PRIMES):
        kern[i, 0] = _as_i32_bits(fwd[i])
        kern[i, 1] = _as_i32_bits(_shoup(fwd[i], p))
        kern[i, 2] = _as_i32_bits(inv[i])
        kern[i, 3] = _as_i32_bits(_shoup(inv[i], p))
        kern[i, 4, 0] = ninv[i]
        kern[i, 4, 1] = _as_i32_bits(_shoup(ninv[i:i + 1], p))[0]
        kern[i, 4, 2] = p
        kern[i, 4, 3] = (1 << 34) // p
    dev = torch.device(device)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return NttTables(t(primes), t(fwd), t(inv), t(ninv), t(kern),
                     t(_garner_host()), t(_explicit_crt_host(N)))


@functools.cache
def _host_monomial_tables(N: int):
    """psi^k for k in [0, 2N) per prime (int64 [P, 2N]), and e [N] int64:
    the odd exponent with spectrum position i = value at psi^e(i).

    psi itself is psi^bitrev(N/2) = psi^1, an entry of the forward twiddle
    table.  e is read off the forward transform of X (position i holds
    psi^e(i)) by the discrete log over the powers of psi, and checked to
    be the same for every prime."""
    fwd, _, _ = _host_tables(N)
    powers = np.empty((len(PRIMES), 2 * N), np.int64)
    for i, p in enumerate(PRIMES):
        psi = int(fwd[i, N // 2])
        acc = 1
        for k in range(2 * N):
            powers[i, k] = acc
            acc = acc * psi % p
    x = torch.zeros(N, dtype=torch.int64)
    x[1] = 1
    spec = forward_ntt(x).numpy()  # [P, N]
    exps = None
    for i in range(len(PRIMES)):
        log = {int(v): k for k, v in enumerate(powers[i])}
        e = np.array([log[int(v)] for v in spec[i]], np.int64)
        if exps is not None and not np.array_equal(e, exps):
            raise AssertionError("spectrum exponents differ between primes")
        exps = e
    if np.any(exps % 2 == 0):
        raise AssertionError("a spectrum position evaluates at an even power")
    return powers, exps


@dataclass(frozen=True)
class MonomialTables:
    """Device copies for the spectra of monomials: powers [P, 2, 2N] int32
    bit patterns of psi^k (k in [0, 2N)) and their Shoup companions;
    exponents [N] int32, e(i)."""

    powers: torch.Tensor
    exponents: torch.Tensor


@functools.cache
def _monomial_tables(N: int, device: str) -> MonomialTables:
    powers, exps = _host_monomial_tables(N)
    out = np.zeros((len(PRIMES), 2, 2 * N), np.int32)
    for i, p in enumerate(PRIMES):
        out[i, 0] = powers[i]
        out[i, 1] = _as_i32_bits(_shoup(powers[i], p))
    dev = torch.device(device)
    return MonomialTables(torch.from_numpy(out).to(dev),
                          torch.from_numpy(exps.astype(np.int32)).to(dev))


def monomial_tables_for(N: int, device: torch.device) -> MonomialTables:
    return _monomial_tables(N, str(torch.device(device)))


def monomial_spectra(d: torch.Tensor, N: int) -> torch.Tensor:
    """Forward spectra of the monomials X^d, d [...] int in [0, 2N) ->
    [..., P, N] int64 canonical residues: psi^(d * e(i) mod 2N) at i."""
    tab = monomial_tables_for(N, d.device)
    idx = (d.to(torch.int64)[..., None] * tab.exponents.to(torch.int64)
           ) % (2 * N)  # [..., N]
    pw = tab.powers[:, 0].to(torch.int64)  # [P, 2N]
    return pw[:, idx].movedim(0, -2)


def tables_for(N: int, device: torch.device) -> NttTables:
    return ntt_tables(N, str(torch.device(device)))


@functools.cache
def _pass_tables(N: int, device: str) -> torch.Tensor:
    return torch.from_numpy(_as_i32_bits(_host_pass_tables(N))).to(
        torch.device(device))


@functools.cache
def _residue_crt(device: str) -> torch.Tensor:
    return torch.from_numpy(_explicit_crt_host(1)).to(torch.device(device))


def residue_crt_for(device: torch.device) -> torch.Tensor:
    """[P, XCRT_WIDTH] int64: the explicit CRT's constants for canonical
    residues r_i of a convolution (no N^-1 to fold in): w_i = (Q/p_i)^-1
    mod p_i, so c_i = r_i w_i mod p_i (`crt_accumulate`'s kernel)."""
    return _residue_crt(str(torch.device(device)))


def pass_tables_for(N: int, device: torch.device) -> torch.Tensor:
    """The NTT core's tables on `device`: [P, PASS_HEADER + 2 W] int32 bit
    patterns of `_host_pass_tables(N)`."""
    return _pass_tables(N, str(torch.device(device)))


def _rows(N: int, device: torch.device, prime: int | None):
    """The NTT tables of every prime, or of prime `prime` alone."""
    tab = tables_for(N, device)
    rows = slice(None) if prime is None else slice(prime, prime + 1)
    return (tab.primes[rows], tab.psi_rev[rows], tab.psi_inv_rev[rows],
            tab.n_inv[rows])


def forward_ntt(x: torch.Tensor, prime: int | None = None) -> torch.Tensor:
    """x [..., N] int64 (any sign) -> [..., P, N] canonical spectra,
    bit-reversed order, one per prime (or [..., 1, N] for prime `prime`
    alone)."""
    N = x.shape[-1]
    primes, psi_rev, _, _ = _rows(N, x.device, prime)
    P = primes.numel()
    lead = x.shape[:-1]
    p = primes.view(-1, 1, 1)
    a = torch.remainder(x.unsqueeze(-2), primes.view(-1, 1))  # [..., P, N]
    m, t = 1, N
    while m < N:
        t //= 2
        a = a.reshape(*lead, P, m, 2, t)
        S = psi_rev[:, m:2 * m].reshape(-1, m, 1)
        u = a[..., 0, :]
        v = a[..., 1, :] * S % p
        a = torch.stack([(u + v) % p, (u - v) % p], dim=-2)
        m *= 2
    return a.reshape(*lead, P, N)


def inverse_ntt(spec: torch.Tensor, prime: int | None = None) -> torch.Tensor:
    """[..., P, N] canonical bit-reversed spectra -> [..., P, N] canonical
    coefficients (negacyclic convolution residues); [..., 1, N] for prime
    `prime` alone."""
    N = spec.shape[-1]
    primes, _, psi_inv_rev, n_inv = _rows(N, spec.device, prime)
    P = primes.numel()
    lead = spec.shape[:-2]
    p = primes.view(-1, 1, 1)
    a = spec
    m, t = N, 1
    while m > 1:
        h = m // 2
        a = a.reshape(*lead, P, h, 2, t)
        S = psi_inv_rev[:, h:2 * h].reshape(-1, h, 1)
        u = a[..., 0, :]
        v = a[..., 1, :]
        a = torch.stack([(u + v) % p, (u - v) % p * S % p], dim=-2)
        t *= 2
        m = h
    a = a.reshape(*lead, P, N)
    return a * n_inv.view(-1, 1) % primes.view(-1, 1)


def _garner_digits(res: torch.Tensor) -> list[torch.Tensor]:
    """[..., P, N] canonical residues -> the balanced mixed-radix digits
    b_i in [-(p_i-1)/2, (p_i-1)/2], int64 [..., N] each, with
    x = sum_i b_i p_0...p_{i-1}."""
    tab = tables_for(res.shape[-1], res.device)
    primes = [int(p) for p in PRIMES]
    inv = tab.crt[:, 2 * len(PRIMES)]
    bs = []
    for i, p in enumerate(primes):
        partial = torch.zeros_like(res[..., 0, :])
        coef = 1
        for j in range(i):
            partial = partial + bs[j] * coef
            coef = coef * primes[j] % p
        d = torch.remainder(res[..., i, :] - partial, p) * inv[i] % p
        bs.append(torch.where(d > p // 2, d - p, d))
    return bs


def crt_to_u64_centered(res: torch.Tensor) -> torch.Tensor:
    """[..., P, N] canonical residues -> [..., N] int64: the integer x with
    |x| <= (M-1)/2 (M = prod p) congruent to them, as a u64 torus word.

    Balanced Garner: mixed-radix digits b_i in [-(p_i-1)/2, (p_i-1)/2] give
    x = sum_i b_i p_0...p_{i-1}, which spans exactly the centered range.  The
    convolutions reconstructed here are below 2^67 << M/2 ~ 2^76, so x is
    the true integer; its value mod 2^64 needs only wrapping int64 products.
    """
    pp = tables_for(res.shape[-1], res.device).crt[:, 2 * len(PRIMES) + 3]
    bs = _garner_digits(res.to(torch.int64))
    x = torch.zeros_like(bs[0])
    for i in range(len(PRIMES)):
        x = x + bs[i] * pp[i]
    return x


def crt_to_u128_centered(res: torch.Tensor) -> torch.Tensor:
    """[..., P, N] canonical residues -> [..., N, 2] int64 (lo, hi) words:
    the same balanced-Garner integer x as `crt_to_u64_centered`, mod 2^128
    (counterpart of tfhe_tpu/ops/ntt.py:539).  Each prefix product
    Q_i = p_0...p_{i-1} (< 2^61) is split into 32-bit halves; the sums
    s_m = sum_i b_i (Q_i >> 32m & (2^32-1)) stay below 5 * 2^15 * 2^32 in
    magnitude, so x = s_0 + s_1 2^32 is exact in int64 pieces."""
    bs = _garner_digits(res.to(torch.int64))
    halves, q = [], 1
    for p in PRIMES:
        halves.append((q & 0xFFFFFFFF, q >> 32))
        q *= int(p)
    s = torch.stack([sum(b * h[m] for b, h in zip(bs, halves))
                     for m in range(2)], dim=-2)  # [..., 2, N]
    return u128.from_signed_planes(s)


def to_balanced(x: torch.Tensor, p) -> torch.Tensor:
    """Canonical residues in [0, p) (p an int or a tensor broadcastable
    against x) -> balanced int32 in [-(p-1)/2, (p-1)/2]."""
    return torch.where(x > p // 2, x - p, x).to(torch.int32)


def shoup16(b: torch.Tensor, p) -> torch.Tensor:
    """Balanced residues b -> their 16-bit Shoup companions
    round(b * 2^16 / p) as int32, rounded as tfhe_tpu/ops/polymul_ntt.py:28
    (shoup_precompute_device) and ops/ntt.py:447 (shoup_precompute_host)
    do: b * 2^16 / p is never a half-integer for odd p, so rounding half up
    away from zero is rounding to nearest."""
    num = b.to(torch.int64) << 16
    return torch.where(num >= 0, (num + p // 2) // p,
                       -((-num + p // 2) // p)).to(torch.int32)
