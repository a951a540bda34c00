"""The port's multi-bit pieces on the CPU == tfhe_tpu's, bit for bit: the
monomial spectra in the port's NTT layout, the switched subset sums, and the
whole multi-bit blind rotation in both schedules (the plain versions of the
kernels, step after step) against tfhe_tpu.core.multibit's CRT-NTT path at
the tests/test_fused_multibit.py cases."""

import functools

import numpy as np
import pytest
import torch

from tfhe_tpu.core.multibit import (_selection_matrix,
                                    multi_bit_blind_rotate as ref_rotate,
                                    prepare_multi_bit_bsk_ntt)
from tfhe_tpu.core.pbs import modulus_switch as ref_modulus_switch
from tfhe_tpu.ops import decomposition as ref_dec

from tfhe_tpu_torch import core
from tfhe_tpu_torch.ops import fused_multibit, ntt
from tfhe_tpu_torch.ops.torus import to_numpy, to_tensor

# (gf, N, L, base_log) of tests/test_fused_multibit.py:25
CASES = [(2, 256, 2, 8), (3, 256, 1, 15)]
IDS = ["gf2N256L2", "gf3N256L1"]
G, NG, B = 2, 4, 4


def _monomial(d, N):
    x = torch.zeros(N, dtype=torch.int64)
    x[d % N] = 1 if d < N else -1  # X^d = -X^(d-N) for d >= N
    return x


@pytest.mark.parametrize("N", [256, 2048])
def test_monomial_spectra_match_the_forward_transform(N):
    # every d in [0, 2N) at N = 256; at N = 2048 the edges and a sample
    if N == 256:
        ds = list(range(2 * N))
    else:
        rng = np.random.default_rng(3)
        ds = [0, 1, N - 1, N, N + 1, 2 * N - 1] + list(
            rng.integers(0, 2 * N, 26))
    want = ntt.forward_ntt(torch.stack([_monomial(int(d), N) for d in ds]))
    got = ntt.monomial_spectra(torch.tensor(ds), N)
    assert got.shape == (len(ds), len(ntt.PRIMES), N)
    assert torch.equal(got, want)


def test_spectrum_positions_evaluate_at_odd_bit_reversed_powers():
    N = 16
    _, exps = ntt._host_monomial_tables(N)
    assert list(exps) == [2 * int(r) + 1 for r in ntt._bitrev(N)]
    tab = ntt.monomial_tables_for(N, "cpu")
    for i, p in enumerate(ntt.PRIMES):
        pw = tab.powers[i, 0].to(torch.int64)
        assert int(pw[0]) == 1 and int(pw[N]) == p - 1  # psi^N = -1
        sh = tab.powers[i, 1].to(torch.int64) & 0xFFFFFFFF
        assert torch.equal(sh, (pw << 32) // p)


def test_switched_subset_sums_match_reference():
    rng = np.random.default_rng(11)
    N, gf, n, Bs = 256, 3, 12, 64
    mask = rng.integers(0, 2**64 - 1, (Bs, n), dtype=np.uint64, endpoint=True)
    mask[:8, :3] = 2**63 + 2**54  # sums that wrap past 2^64
    got = to_numpy(core.switched_subset_sums(to_tensor(mask, "cpu"), gf, N)
                   .to(torch.int64))  # [n/gf, B, 2^gf]
    groups = mask.reshape(Bs, n // gf, gf).transpose(1, 0, 2)
    sel = _selection_matrix(gf)  # [2^gf, gf], row j = bits of j MSB-first
    with np.errstate(over="ignore"):
        sums = (groups[:, :, None, :] * sel[None, None]).sum(
            axis=-1, dtype=np.uint64)
    want = np.asarray(ref_modulus_switch(sums, N)).astype(np.int64) % (2 * N)
    assert np.array_equal(got.astype(np.int64), want)
    # the sum wraps before the switch: switching each term first differs
    single = np.asarray(ref_modulus_switch(groups, N)).astype(np.int64)
    apart = (single[:, :, None, :] * sel[None, None].astype(np.int64)).sum(
        axis=-1) % (2 * N)
    assert np.any(apart != want)


def test_subset_bits_select_mask_elements_msb_first():
    N, gf = 256, 3
    mask = torch.zeros((1, gf), dtype=torch.int64)
    mask[0, 0] = 1 << 60  # a_0: switches to 2N / 16 = 32
    d = core.switched_subset_sums(mask, gf, N)[0, 0]  # [2^gf]
    # subset j holds a_0 exactly when bit gf-1 of j is set
    assert d.tolist() == [0, 0, 0, 0, 32, 32, 32, 32]


@pytest.mark.parametrize("bl,L", [(8, 2), (15, 1), (21, 1)])
def test_decompose_plain_matches_reference(bl, L):
    rng = np.random.default_rng(bl)
    acc = rng.integers(0, 2**64 - 1, (3, G, 64), dtype=np.uint64,
                       endpoint=True)
    acc[0, 0, :3] = [0, 2**64 - 1, 2**63]
    want = np.asarray(ref_dec.signed_decompose(acc, bl, L)).transpose(
        0, 3, 1, 2)
    got = fused_multibit.decompose_plain(to_tensor(acc, "cpu"), bl, L)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


@functools.cache
def _case(i):
    gf, N, L, bl = CASES[i]
    rng = np.random.default_rng(7)
    per, n = 1 << gf, NG * gf
    mbsk = rng.integers(0, 1 << 64, (NG, per, L, G, G, N), dtype=np.uint64)
    lwe = rng.integers(0, 1 << 64, (B, n + 1), dtype=np.uint64)
    lut = rng.integers(0, 1 << 64, (B, G, N), dtype=np.uint64)
    want = np.asarray(ref_rotate(prepare_multi_bit_bsk_ntt(mbsk, bl, gf),
                                 lut, lwe))
    return mbsk, lwe, lut, want


@pytest.mark.parametrize("mode", fused_multibit.MODES)
@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_blind_rotate_matches_reference(i, mode):
    gf, N, L, bl = CASES[i]
    mbsk, lwe, lut, want = _case(i)
    key = core.prepare_multi_bit_bsk_cuda(to_tensor(mbsk, "cpu"), bl, gf)
    assert key.kspec.shape == (NG, 1 << gf, len(ntt.PRIMES), L * G, G, 2, N)
    got = core.multi_bit_blind_rotate(key, to_tensor(lut, "cpu"),
                                      to_tensor(lwe, "cpu"), mode=mode)
    assert np.array_equal(to_numpy(got), want)


def test_one_step_schedules_agree():
    # one group step in both schedules, the wrappers called on their own
    # and through the group-step loop
    gf, N, L, bl = CASES[1]
    rng = np.random.default_rng(5)
    key = core.prepare_multi_bit_bsk_cuda(to_tensor(rng.integers(
        0, 1 << 64, (1, 1 << gf, L, G, G, N), dtype=np.uint64), "cpu"), bl, gf)
    acc = to_tensor(rng.integers(0, 1 << 64, (3, G, N), dtype=np.uint64),
                    "cpu")
    d = torch.from_numpy(rng.integers(0, 2 * N, (3, 1 << gf)).astype(np.int32))
    d[:, 0] = 0
    comb = fused_multibit.multibit_combine(d, key.kspec[0])
    scan3 = fused_multibit.multibit_external_product(acc, comb, bl, L)
    scan1 = fused_multibit.multibit_step(acc, d, key.kspec[0], bl, L)
    assert torch.equal(scan3, scan1)
    whole = fused_multibit.multi_bit_blind_rotate_cuda(key, acc, d[None])
    assert torch.equal(whole, scan3)


def test_mode_must_be_named_and_pbs_then_keyswitch_is_ported():
    gf, N, L, bl = CASES[0]
    key = core.prepare_multi_bit_bsk_cuda(
        torch.zeros((1, 1 << gf, L, G, G, N), dtype=torch.int64), bl, gf)
    acc = torch.zeros((1, G, N), dtype=torch.int64)
    d = torch.zeros((1, 1, 1 << gf), dtype=torch.int32)
    with pytest.raises(ValueError, match="mode"):
        fused_multibit.multi_bit_blind_rotate_cuda(key, acc, d, mode="scan2")
    with pytest.raises(ValueError):
        core.prepare_multi_bit_bsk_cuda(
            torch.zeros((1, 3, L, G, G, N), dtype=torch.int64), bl, gf)
    # PBS then keyswitch is now ported: the keyswitch of the PBS's output
    n = key.input_dim
    rng = np.random.default_rng(3)
    ksk = core.prepare_ksk(to_tensor(rng.integers(
        0, 1 << 64, ((G - 1) * N, 2, n + 1), dtype=np.uint64), "cpu"), 4)
    lwe = to_tensor(rng.integers(0, 1 << 64, (2, n + 1), dtype=np.uint64),
                    "cpu")
    got = core.multi_bit_pbs_then_keyswitch(ksk, key, acc[0], lwe)
    want = core.keyswitch(ksk, core.multi_bit_programmable_bootstrap(
        key, acc[0], lwe))
    assert got.shape == (2, n + 1) and torch.equal(got, want)
