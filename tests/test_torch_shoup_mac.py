"""The port's K10 (tfhe_tpu_torch.ops.shoup_mac, its plain version on the
CPU) == the reference's Pallas `shoup_mac` (tfhe_tpu/ops/pallas_kernels.py,
interpret mode on the CPU, as tests/test_pallas.py runs it), word for word,
for each of the five primes at tests/test_pallas.py's shape and at the three
paths' shapes (shortint, boolean, u128) with N cut to 256 / 512; congruent
to `shoup_mac_reference` and within 3p/2 as tests/test_pallas.py asks; the
all-primes call `shoup_mac_primes` (one launch a step on a card) == the
reference's kernel run once per prime and laid out as [B, GM, P, N], at the
three paths' shapes and N = 256 / 512; and the wrappers' checks."""

import numpy as np
import pytest
import torch

from tfhe_tpu.ops import ntt as ref_ntt
from tfhe_tpu.ops import pallas_kernels as pk

from tfhe_tpu_torch.ops import ntt, shoup_mac

# (B, LJ, GM, N): tests/test_pallas.py's shape, then shortint
# (L*G = 2, G*M = 4), boolean (9, 3) and u128 (2, 8) with N cut down
SHAPES = [(3, 2, 8, 256), (3, 2, 4, 256), (2, 9, 3, 512), (2, 2, 8, 256)]
SHAPE_IDS = ["pallas_test", "shortint", "boolean", "u128"]


def _inputs(p, B, LJ, GM, N):
    rng = np.random.default_rng([p, B, LJ, GM, N])
    h = p // 2
    a = rng.integers(-h, h + 1, (B, LJ, N)).astype(np.int32)
    ks = rng.integers(-h, h + 1, (LJ, GM, N)).astype(np.int32)
    ksh = ref_ntt.shoup_precompute_host(ks.astype(np.int64), p)
    return a, ks, ksh


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("p", ref_ntt.PRIMES)
def test_plain_equals_the_pallas_kernel(p, shape):
    a, ks, ksh = _inputs(p, *shape)
    want = np.asarray(pk.shoup_mac(a, ks, ksh, p))
    got = shoup_mac.shoup_mac(*(torch.from_numpy(x) for x in (a, ks, ksh)),
                              p)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    # tests/test_pallas.py's checks, against the jnp formulation
    ref = np.asarray(pk.shoup_mac_reference(a, ks, ksh, p))
    assert ((got.numpy().astype(np.int64) - ref) % p == 0).all()
    assert np.abs(got.numpy()).max() <= 3 * p // 2
    # and the exact sum, balanced
    exact = np.einsum("bjn,jgn->bgn", a.astype(object), ks.astype(object))
    bal = (exact + p // 2) % p - p // 2
    assert np.array_equal(got.numpy().astype(object), bal)


@pytest.mark.parametrize("N", [256, 512])
@pytest.mark.parametrize("shape", SHAPES[1:], ids=SHAPE_IDS[1:])
def test_all_primes_plain_equals_the_pallas_kernel_per_prime(shape, N):
    B, LJ, GM, _ = shape
    ins = [_inputs(p, B, LJ, GM, N) for p in ref_ntt.PRIMES]
    want = np.stack([np.asarray(pk.shoup_mac(a, ks, ksh, p))
                     for (a, ks, ksh), p in zip(ins, ref_ntt.PRIMES)], axis=2)
    a, ks, ksh = (torch.from_numpy(np.stack(x)) for x in zip(*ins))
    assert a.shape == (len(ref_ntt.PRIMES), B, LJ, N)
    shoup_mac.reset_launch_counts()
    got = shoup_mac.shoup_mac_primes(a, ks, ksh, ref_ntt.PRIMES)
    assert got.shape == (B, GM, len(ref_ntt.PRIMES), N)
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(got, shoup_mac.shoup_mac_primes_plain(
        a, ks, ksh, ref_ntt.PRIMES))
    assert shoup_mac.shoup_mac_primes.launches == 0  # CPU: the plain version


def test_shoup_companions_match_the_reference():
    rng = np.random.default_rng(5)
    for p in ref_ntt.PRIMES:
        b = rng.integers(-(p // 2), p // 2 + 1, 4096).astype(np.int64)
        b[:2] = (-(p // 2), p // 2)
        got = ntt.shoup16(torch.from_numpy(b), p).numpy()
        assert np.array_equal(got, ref_ntt.shoup_precompute_host(b, p))
        canon = torch.from_numpy(b % p)
        assert np.array_equal(ntt.to_balanced(canon, p).numpy(), b)


def test_wrapper_takes_the_plain_version_for_cpu_tensors_only():
    p = ref_ntt.PRIMES[1]
    a, ks, ksh = (torch.from_numpy(x) for x in _inputs(p, 2, 2, 4, 256))
    shoup_mac.reset_launch_counts()
    got = shoup_mac.shoup_mac(a, ks, ksh, p)
    assert torch.equal(got, shoup_mac.shoup_mac_plain(a, ks, ksh, p))
    got = shoup_mac.shoup_mac_primes(a[None], ks[None], ksh[None], (p,))
    assert torch.equal(got[:, :, 0], shoup_mac.shoup_mac_plain(a, ks, ksh, p))
    assert shoup_mac.shoup_mac.launches == 0  # the plain version counts none
    assert shoup_mac.shoup_mac_primes.launches == 0
    assert shoup_mac.KERNELS == (shoup_mac.shoup_mac,
                                 shoup_mac.shoup_mac_primes)
    meta = [t.to("meta") for t in (a, ks, ksh)]
    with pytest.raises(ValueError, match="unsupported device"):
        shoup_mac.shoup_mac(*meta, p)
    with pytest.raises(ValueError, match="unsupported device"):
        shoup_mac.shoup_mac_primes(*(t[None] for t in meta), (p,))


@pytest.mark.parametrize("bad", ["dtype", "key_shape", "shoup_shape", "rank",
                                 "strided", "prime", "lj"])
def test_wrapper_refuses_bad_inputs(bad):
    p = ref_ntt.PRIMES[0]
    a, ks, ksh = (torch.from_numpy(x) for x in _inputs(p, 2, 2, 4, 256))
    if bad == "dtype":
        a = a.to(torch.int64)
    elif bad == "key_shape":
        ks = ks[:, :, :128]
    elif bad == "shoup_shape":
        ksh = ksh[:, :2]
    elif bad == "rank":
        a = a[0]
    elif bad == "strided":
        a = torch.from_numpy(np.ascontiguousarray(
            np.repeat(a.numpy(), 2, axis=-1)))[..., ::2]
    elif bad == "prime":
        p = 65536
    else:  # LJ = 16 digit rows: past the kernel's rounding argument
        a = torch.zeros((2, 16, 256), dtype=torch.int32)
        ks = ksh = torch.zeros((16, 4, 256), dtype=torch.int32)
    with pytest.raises(ValueError):
        shoup_mac.shoup_mac(a, ks, ksh, p)
    if bad != "rank":  # the all-primes call refuses the same inputs
        with pytest.raises(ValueError):
            shoup_mac.shoup_mac_primes(a[None], ks[None], ksh[None], (p,))


@pytest.mark.parametrize("bad", ["primes", "too_many_primes", "rank"])
def test_all_primes_wrapper_refuses_bad_inputs(bad):
    p = ref_ntt.PRIMES[0]
    a, ks, ksh = (torch.from_numpy(x)[None] for x in _inputs(p, 2, 2, 4, 256))
    primes = (p,)
    if bad == "primes":  # one prime for two digit blocks
        a, ks, ksh = (torch.cat([t, t]) for t in (a, ks, ksh))
    elif bad == "too_many_primes":  # nine: past the kernel's kMaxPrimes
        a, ks, ksh = (t.expand(9, *t.shape[1:]).contiguous()
                      for t in (a, ks, ksh))
        primes = (p,) * 9
    else:
        a = a[0]
    with pytest.raises(ValueError):
        shoup_mac.shoup_mac_primes(a, ks, ksh, primes)
