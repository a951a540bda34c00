"""A plain PyTorch model of K5 `blind_rotate_persistent`'s kernel on the
register-resident NTT core (`blind_rotate_stream_cluster_kernel`,
tfhe_tpu_torch/ops/csrc/ntt_core_kernels.cuh), checked word for word on
the CPU.

The kernel loops K4's cluster step over all n steps on one accumulator
buffer in device memory, in place.  The model does the same with the step
model of tests/test_torch_ntt_core_steps.py (the digits each thread makes,
K2's cluster product and explicit CRT on the core's model): the
accumulator is held as the P CTAs' CRT shares, words [i share, (i + 1)
share) of each ciphertext's [G, N] (share = ceil(G N / P)), the only words
CTA i writes; every word the rotation reads is the one its owner stored
last; CTA i makes the digits of the thread indices [floor(i T / P),
floor((i + 1) T / P)) (T = N/8); and each CTA's CRT writes only its own
share, reading only its own share's old words, so the order in which the
CTAs write does not reach the result.  Checked: the
shares and the digit shares partition the words; the model equals
`blind_rotate_persistent_plain` and, through a blind rotation in mode
"grid" whose rotation is the model, the reference's own Pallas
`fused_blind_rotate_grid` interpreted on the CPU, at the four
tests/test_fused_pbs.py cases."""

import numpy as np
import pytest
import torch

from tfhe_tpu.ops import fused_pbs as ref_fused

from tfhe_tpu_torch import core
from tfhe_tpu_torch.ops import fused_pbs, ntt
from tfhe_tpu_torch.ops.torus import to_numpy, to_tensor
from test_torch_cases import CASES, IDS, rand_inputs
from test_torch_ntt_core import model_external_product
from test_torch_ntt_core_steps import model_digits

RADIX = 8  # words of a polynomial a thread of the core holds


def crt_shares(G, N, P):
    """Each CTA's CRT share of a ciphertext's G*N words: (start, end)."""
    share = -(-G * N // P)
    return share, [(i * share, min(G * N, (i + 1) * share)) for i in range(P)]


def digit_words(N, P, pi):
    """The words j = tid + k N/8 whose digits CTA pi makes."""
    T = N // RADIX
    tid = torch.arange(pi * T // P, (pi + 1) * T // P)
    return (tid[:, None] + torch.arange(RADIX)[None, :] * T).reshape(-1)


def model_rotation(acc, ahat, kspec, kshoup, base_log, levels, bits=64, *,
                   primes):
    """K5 as its kernel computes it: acc [B, G, N], ahat [n, B], kspec /
    kshoup [n, P, LJ, O, M, N] -> the accumulator after n steps."""
    B, G, N = acc.shape
    P = kspec.shape[1]
    share, bounds = crt_shares(G, N, P)
    words = torch.arange(G * N)
    owner, at = words // share, words % share
    flat = acc.reshape(B, G * N)
    own = [flat[:, lo:hi].clone() for lo, hi in bounds]  # copied in
    for s in range(ahat.shape[0]):
        # the rotation reads every word as its owner stored it
        held = torch.zeros((P, B, share), dtype=acc.dtype)
        for pi, words_of in enumerate(own):
            held[pi, :, :words_of.shape[1]] = words_of
        cur = held[owner, :, at].T.reshape(B, G, N)
        made = model_digits(cur, ahat[s], base_log, levels, bits)
        dig = torch.zeros_like(made)
        for pi in range(P):
            j = digit_words(N, P, pi)
            dig[..., j] = made[..., j]
        new = model_external_product(dig, kspec[s], kshoup[s], cur,
                                     bits, primes).reshape(B, G * N)
        # each CTA writes its own share, in place; last CTA first
        for pi in reversed(range(P)):
            lo, hi = bounds[pi]
            own[pi] = new[:, lo:hi]
    return torch.cat(own, dim=1).reshape(B, G, N)


@pytest.mark.parametrize("N", [256, 512, 1024, 2048])
def test_shares_partition_the_words(N):
    # every cluster size a key's set gives: 2 ... 8 CTAs
    for P in range(2, ntt.MAX_PRIMES + 1):
        for G in (2, 3, 4):
            _, bounds = crt_shares(G, N, P)
            assert bounds[0][0] == 0 and bounds[-1][1] == G * N
            assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
        made = torch.cat([digit_words(N, P, pi) for pi in range(P)])
        assert torch.equal(torch.sort(made).values, torch.arange(N))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_rotation_model_equals_plain_and_the_reference(case, monkeypatch):
    rng = np.random.default_rng(47)
    bl, L, G, N, bits = (case[k] for k in ("bl", "L", "G", "N", "bits"))
    bsk_std, lut, lwe = rand_inputs(rng, *(case[k] for k in "nLGNB"), bits)
    key = core.prepare_bsk_cuda(to_tensor(bsk_std, "cpu"), bl, bits)
    acc = to_tensor(rng.integers(0, 2**bits - 1, (3, G, N), dtype=np.uint64,
                                 endpoint=True), "cpu")
    ahat = torch.from_numpy(rng.integers(0, 2 * N, (case["n"], 3),
                                         endpoint=True).astype(np.int32))
    ahat[0, 0] = 2 * N  # rotates as 0
    assert torch.equal(
        model_rotation(acc, ahat, key.kspec, key.kshoup, bl, L, bits,
                       primes=key.primes),
        fused_pbs.blind_rotate_persistent_plain(acc, ahat, key.kspec, bl, L,
                                                bits, primes=key.primes))

    # a blind rotation in mode "grid" whose rotation is the model, against
    # the reference's Pallas grid kernel in interpret mode
    monkeypatch.setattr(fused_pbs, "blind_rotate_persistent", model_rotation)
    got = core.blind_rotate(key, to_tensor(lut, "cpu"), to_tensor(lwe, "cpu"),
                            mode="grid")
    monkeypatch.setenv("TFHE_TPU_FUSED_MODE", "grid")
    want = np.asarray(ref_fused.blind_rotate_fused(
        ref_fused.prepare_bsk_fused(bsk_std, bl, bits=bits), lut, lwe))
    assert np.array_equal(to_numpy(got, bits), want)
