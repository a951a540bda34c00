"""K10's CUDA kernel (tfhe_tpu_torch.ops.shoup_mac) against its plain
versions, bit for bit, on a card (tolerance 0), through both wrappers (one
prime a launch, `shoup_mac`; every prime of a step in one launch,
`shoup_mac_primes`): every prime at the three paths' full widths (shortint
PARAM_MESSAGE_2_CARRY_2_KS_PBS, boolean DEFAULT_PARAMETERS, the u128 PBS)
with B = 64, an empty batch, a batch past 65535 in one launch, and inputs
it refuses; then the CRT-NTT layout's blind rotation at 32, 64 and 128 bits
(one K10 launch a step) and shortint and boolean keys with mode="ntt",
card against CPU at test size.  Marked `cuda`: they skip where
there is no card; on one, run `python -m pytest -m cuda --noconftest
tests/test_torch_ntt_kernels_cuda.py` (tests/conftest.py imports JAX, which
is not needed here)."""

import numpy as np
import pytest
import torch

from tfhe_tpu_torch import boolean, core, shortint
from tfhe_tpu_torch.ops import ntt, shoup_mac, u128
from tfhe_tpu_torch.params import (BOOLEAN_TEST_PARAMETERS,
                                   PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST)
from test_torch_cases import CASES, IDS, rand_inputs

pytestmark = pytest.mark.cuda

# (LJ, GM, N) of the three paths: L*G digit rows, G*M output planes
WIDTHS = {"shortint": (2, 4, 2048), "boolean": (9, 3, 512),
          "u128": (2, 8, 2048)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def _inputs(rng, p, B, LJ, GM, N, dev):
    h = p // 2
    a = torch.from_numpy(rng.integers(-h, h + 1, (B, LJ, N)).astype(
        np.int32)).to(dev)
    ks = torch.from_numpy(rng.integers(-h, h + 1, (LJ, GM, N)).astype(
        np.int32)).to(dev)
    return a, ks, ntt.shoup16(ks, p)


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_kernel_matches_plain_at_full_width(width, card):
    rng = np.random.default_rng(3)
    LJ, GM, N = WIDTHS[width]
    for p in ntt.PRIMES:
        a, ks, ksh = _inputs(rng, p, 64, LJ, GM, N, card)
        a[0, 0, :4] = torch.tensor([-(p // 2), p // 2, 0, 1])
        ks[0, 0, :4] = torch.tensor([p // 2, p // 2, -(p // 2), -(p // 2)])
        ksh = ntt.shoup16(ks, p)
        before = shoup_mac.shoup_mac.launches
        got = shoup_mac.shoup_mac(a, ks, ksh, p)
        torch.cuda.synchronize()
        assert shoup_mac.shoup_mac.launches == before + 1
        assert torch.equal(got, shoup_mac.shoup_mac_plain(a, ks, ksh, p))


def _all_primes_inputs(rng, B, LJ, GM, N, dev):
    ins = [_inputs(rng, p, B, LJ, GM, N, dev) for p in ntt.PRIMES]
    return tuple(torch.stack(x) for x in zip(*ins))


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_all_primes_kernel_matches_plain_at_full_width(width, card):
    rng = np.random.default_rng(9)
    LJ, GM, N = WIDTHS[width]
    a, ks, ksh = _all_primes_inputs(rng, 64, LJ, GM, N, card)
    for i, p in enumerate(ntt.PRIMES):  # the extremes of every prime
        a[i, 0, 0, :4] = torch.tensor([-(p // 2), p // 2, 0, 1])
        ks[i, 0, 0, :4] = torch.tensor([p // 2, p // 2, -(p // 2),
                                        -(p // 2)])
        ksh[i] = ntt.shoup16(ks[i], p)
    shoup_mac.reset_launch_counts()
    got = shoup_mac.shoup_mac_primes(a, ks, ksh, ntt.PRIMES)
    torch.cuda.synchronize()
    assert [k.launches for k in shoup_mac.KERNELS] == [0, 1]
    assert torch.equal(got, shoup_mac.shoup_mac_primes_plain(a, ks, ksh,
                                                             ntt.PRIMES))


def test_empty_batch_launches_nothing(card):
    a, ks, ksh = _inputs(np.random.default_rng(4), 12289, 0, 2, 4, 256, card)
    before = shoup_mac.shoup_mac.launches
    out = shoup_mac.shoup_mac(a, ks, ksh, 12289)
    assert out.shape == (0, 4, 256)
    assert shoup_mac.shoup_mac.launches == before
    a, ks, ksh = _all_primes_inputs(np.random.default_rng(4), 0, 2, 4, 256,
                                    card)
    before = shoup_mac.shoup_mac_primes.launches
    out = shoup_mac.shoup_mac_primes(a, ks, ksh, ntt.PRIMES)
    assert out.shape == (0, 4, len(ntt.PRIMES), 256)
    assert shoup_mac.shoup_mac_primes.launches == before


def test_batch_beyond_a_grid_dimension_of_65535(card):
    p, B = 86017, 65536 + 8
    a, ks, ksh = _inputs(np.random.default_rng(5), p, B, 2, 4, 256, card)
    out = shoup_mac.shoup_mac(a, ks, ksh, p)
    rows = torch.cat([torch.arange(8), torch.arange(B - 16, B)]).to(card)
    torch.cuda.synchronize()
    assert torch.equal(out[rows], shoup_mac.shoup_mac_plain(a[rows], ks, ksh,
                                                            p))


def test_all_primes_batch_beyond_a_grid_dimension_of_65535(card):
    B = 65536 + 8
    a, ks, ksh = _all_primes_inputs(np.random.default_rng(7), B, 2, 4, 256,
                                    card)
    out = shoup_mac.shoup_mac_primes(a, ks, ksh, ntt.PRIMES)
    rows = torch.cat([torch.arange(8), torch.arange(B - 16, B)]).to(card)
    torch.cuda.synchronize()
    assert torch.equal(out[rows], shoup_mac.shoup_mac_primes_plain(
        a[:, rows].contiguous(), ks, ksh, ntt.PRIMES))


def test_bad_inputs_are_refused(card):
    p = 40961
    a, ks, ksh = _inputs(np.random.default_rng(6), p, 4, 2, 4, 256, card)
    for args in ((a.to(torch.int64), ks, ksh), (a, ks.cpu(), ksh),
                 (a[..., ::2], ks[..., ::2], ksh[..., ::2]),
                 (a, ks, ksh[:1]), (a[:, :1], ks, ksh)):
        with pytest.raises(ValueError):
            shoup_mac.shoup_mac(*args, p)
    with pytest.raises(ValueError):
        shoup_mac.shoup_mac(a, ks, ksh, 65536)


def test_all_primes_bad_inputs_are_refused(card):
    rng = np.random.default_rng(10)
    a, ks, ksh = _all_primes_inputs(rng, 4, 2, 4, 256, card)
    for args in ((a.to(torch.int64), ks, ksh), (a, ks.cpu(), ksh),
                 (a[..., ::2], ks[..., ::2], ksh[..., ::2]),
                 (a, ks, ksh[:, :1]), (a[:, :, :1], ks, ksh), (a[:2], ks,
                                                               ksh)):
        with pytest.raises(ValueError):
            shoup_mac.shoup_mac_primes(*args, ntt.PRIMES)
    with pytest.raises(ValueError):
        shoup_mac.shoup_mac_primes(a, ks, ksh, ntt.PRIMES[:-1] + (65536,))
    # the kernel reads 16-byte vectors: N a multiple of 4, aligned tensors
    a6, ks6, ksh6 = _all_primes_inputs(rng, 4, 2, 4, 6, card)
    with pytest.raises(ValueError, match="multiple of 4"):
        shoup_mac.shoup_mac_primes(a6, ks6, ksh6, ntt.PRIMES)
    shifted = torch.empty(a.numel() + 1, dtype=torch.int32, device=card)
    shifted[1:] = a.reshape(-1)
    with pytest.raises(ValueError, match="aligned"):
        shoup_mac.shoup_mac_primes(shifted[1:].view(a.shape), ks, ksh,
                                   ntt.PRIMES)


def _words(rng, shape, bits, dev):
    if bits == 128:
        return u128.to_tensor(rng.integers(0, 2**64 - 1, shape + (2,),
                                           dtype=np.uint64, endpoint=True),
                              dev)
    hi = 2**64 - 1 if bits == 64 else 2**32 - 1
    x = rng.integers(0, hi, shape, dtype=np.uint64, endpoint=True)
    return torch.from_numpy(x.view(np.int64)).to(dev)


@pytest.mark.parametrize("case", CASES + [dict(n=3, L=2, G=2, N=64, B=8,
                                               bl=18, bits=128)],
                         ids=IDS + ["n3L2G2N64u128"])
def test_ntt_rotation_card_equals_cpu(case, card):
    rng = np.random.default_rng(8)
    n, L, G, N, B, bl, bits = (case[k] for k in ("n", "L", "G", "N", "B",
                                                 "bl", "bits"))
    raw = _words(rng, (n, L, G, G, N), bits, "cpu")
    lut = _words(rng, (G, N), bits, "cpu")
    lwe = _words(rng, (B, n + 1), bits, "cpu")
    want = core.blind_rotate(core.prepare_bsk_ntt(raw, bl, bits, "cpu"), lut,
                             lwe)
    shoup_mac.reset_launch_counts()
    got = core.blind_rotate(core.prepare_bsk_ntt(raw, bl, bits, card),
                            lut.to(card), lwe.to(card))
    torch.cuda.synchronize()
    # one launch a step for every prime
    assert [k.launches for k in shoup_mac.KERNELS] == [0, n]
    assert torch.equal(got.cpu(), want)


def test_ntt_keys_card_equal_cpu(card):
    outs = {}
    for where in (card, "cpu"):
        c, s = shortint.gen_keys(PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST,
                                 seed=5, device=where, mode="ntt")
        b = c.encrypt_batch(np.arange(16))
        o = s.apply_lookup_table_batch(b, s.generate_lookup_table(
            lambda x: (3 * x + 2) % 16))
        assert np.array_equal(c.decrypt_batch_message_and_carry(o),
                              (3 * np.arange(16) + 2) % 16)
        bc, bs = boolean.gen_keys(BOOLEAN_TEST_PARAMETERS, seed=5,
                                  device=where, mode="ntt")
        x = np.array([False, True, False, True])
        y = np.array([False, False, True, True])
        g = bs.nand_batch(bc.encrypt_batch(x), bc.encrypt_batch(y))
        assert np.array_equal(bc.decrypt_batch(g), ~(x & y))
        outs[str(where)] = (o.data.cpu(), g.cpu())
    card_out, cpu_out = outs[str(card)], outs["cpu"]
    assert all(torch.equal(u, v) for u, v in zip(card_out, cpu_out))
