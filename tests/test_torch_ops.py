"""Port's torus primitives == tfhe_tpu's, bit for bit (tolerance 0):
decomposition, monomial rotations, modulus switch, sample extract, limbs;
plus the exact NTT and CRT against schoolbook and Python integers."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tfhe_tpu.core import pbs as ref_pbs
from tfhe_tpu.core import secret as ref_secret
from tfhe_tpu.ops import decomposition as ref_dec
from tfhe_tpu.ops import polymul as ref_poly

from tfhe_tpu_torch.core import glwe_phase, modulus_switch, sample_extract
from tfhe_tpu_torch.ops import decomposition, ntt, polymul
from tfhe_tpu_torch.ops.torus import to_numpy, to_tensor

EDGE_U64 = np.array([0, 1, 2**63 - 1, 2**63, 2**63 + 1, 2**64 - 1,
                     0xFFFFFFFF, 2**62], dtype=np.uint64)


def _words(rng, shape, bits):
    if bits == 64:
        x = rng.integers(0, 2**64 - 1, shape, dtype=np.uint64, endpoint=True)
        x.reshape(-1)[:EDGE_U64.size] = EDGE_U64
        return x
    x = rng.integers(0, 2**32 - 1, shape, dtype=np.uint32, endpoint=True)
    x.reshape(-1)[:4] = [0, 2**31, 2**32 - 1, 2**31 - 1]
    return x


@pytest.mark.parametrize("bl,L,bits", [(23, 1, 64), (15, 2, 64), (9, 4, 64),
                                       (3, 5, 64), (6, 8, 64), (18, 1, 32),
                                       (7, 3, 32), (8, 2, 32)])
def test_signed_decompose_matches_reference(bl, L, bits):
    rng = np.random.default_rng(bl * 31 + L)
    x = _words(rng, (4, 64), bits)
    t = to_tensor(x, "cpu")
    want_cr = np.asarray(ref_dec.closest_representable(x, bl, L, bits=bits))
    got_cr = to_numpy(decomposition.closest_representable(t, bl, L, bits), bits)
    assert np.array_equal(got_cr, want_cr)
    want = np.asarray(ref_dec.signed_decompose(x, bl, L, bits=bits))
    got = decomposition.signed_decompose(t, bl, L, bits).numpy()
    assert got.dtype == np.int32
    assert np.array_equal(got, want)


@pytest.mark.parametrize("bits", [64, 32])
@pytest.mark.parametrize("N", [256, 512])
def test_monomial_mul_div_match_reference(N, bits):
    rng = np.random.default_rng(N + bits)
    poly = _words(rng, (7, 2, N), bits)
    deg = np.array([0, N - 1, N, 2 * N - 1, 2 * N, 1, 777 % (2 * N)],
                   dtype=np.int32)[:, None]
    t = to_tensor(poly, "cpu")
    for ours, ref in ((polymul.monomial_mul, ref_poly.monomial_mul),
                      (polymul.monomial_div, ref_poly.monomial_div)):
        want = np.asarray(ref(poly, deg, N, bits=bits))
        got = to_numpy(ours(t, torch.from_numpy(deg), N, bits), bits)
        assert np.array_equal(got, want)


@pytest.mark.parametrize("bits", [64, 32])
@pytest.mark.parametrize("N", [256, 2048])
def test_modulus_switch_matches_reference(N, bits):
    rng = np.random.default_rng(N * bits)
    x = _words(rng, (5, 100), bits)
    want = np.asarray(ref_pbs.modulus_switch(x, N, bits=bits))
    got = modulus_switch(to_tensor(x, "cpu"), N, bits).numpy()
    assert got.dtype == np.int32
    assert np.array_equal(got, want)
    assert got.min() >= 0 and got.max() <= 2 * N


@pytest.mark.parametrize("G", [2, 3])
def test_sample_extract_matches_reference(G):
    rng = np.random.default_rng(G)
    glwe = _words(rng, (3, G, 256), 64)
    want = np.asarray(ref_pbs.sample_extract(jnp.asarray(glwe)))
    got = to_numpy(sample_extract(to_tensor(glwe, "cpu")))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("bits", [64, 32])
def test_glwe_phase_matches_reference(bits):
    rng = np.random.default_rng(bits)
    k, N = 2, 256
    s = rng.integers(0, 2, (k, N)).astype(np.uint64)
    masks = _words(rng, (3, k, N), bits)
    smat = ref_secret.binary_ext_matrix(s, N)
    want = np.asarray(ref_secret.glwe_phase(smat, jnp.asarray(masks), bits=bits))
    got = to_numpy(glwe_phase(to_tensor(s, "cpu"), to_tensor(masks, "cpu"),
                              bits), bits)
    assert np.array_equal(got, want)


def _negacyclic_schoolbook(a, b):
    N = len(a)
    c = [0] * N
    for i in range(N):
        for j in range(N):
            if i + j < N:
                c[i + j] += a[i] * b[j]
            else:
                c[i + j - N] -= a[i] * b[j]
    return c


@pytest.mark.parametrize("N", [16, 256])
def test_ntt_round_trip_and_product_mod_p(N):
    rng = np.random.default_rng(N)
    a = torch.from_numpy(rng.integers(-2**22, 2**22, (2, N)))
    b = torch.from_numpy(rng.integers(0, 2**32, (2, N)))
    primes = ntt.tables_for(N, "cpu").primes.view(-1, 1)
    A = ntt.forward_ntt(a)
    assert A.shape == (2, len(ntt.PRIMES), N)
    assert torch.equal(ntt.inverse_ntt(A), torch.remainder(a[:, None], primes))
    prod = ntt.inverse_ntt(A * ntt.forward_ntt(b) % primes)
    for r in range(2):
        c = _negacyclic_schoolbook([int(v) for v in a[r]], [int(v) for v in b[r]])
        for i, p in enumerate(ntt.PRIMES):
            assert [v % p for v in c] == [int(v) for v in prod[r, i]]


@pytest.mark.parametrize("prime", range(len(ntt.PRIMES)))
def test_ntt_of_one_prime_is_that_row(prime):
    rng = np.random.default_rng(prime)
    a = torch.from_numpy(rng.integers(-2**31, 2**31, (3, 64)))
    A = ntt.forward_ntt(a)
    one = ntt.forward_ntt(a, prime)
    assert one.shape == (3, 1, 64)
    assert torch.equal(one, A[:, prime:prime + 1])
    assert torch.equal(ntt.inverse_ntt(one, prime),
                       ntt.inverse_ntt(A)[:, prime:prime + 1])


def test_crt_to_u64_matches_python_integers():
    rng = np.random.default_rng(5)
    half = (ntt.CRT_MODULUS - 1) // 2
    vals = [0, 1, -1, half, -half, 2**67, -(2**67) + 12345, 2**64 + 7]
    vals += [int(v) * int(w) for v, w in zip(rng.integers(-2**40, 2**40, 24),
                                             rng.integers(-2**35, 2**35, 24))]
    res = torch.tensor([[v % p for v in vals] for p in ntt.PRIMES])
    got = ntt.crt_to_u64_centered(res).numpy().view(np.uint64)
    assert [int(g) for g in got] == [v % 2**64 for v in vals]
