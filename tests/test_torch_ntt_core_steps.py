"""The plain PyTorch model of the register-resident NTT core
(tests/test_torch_ntt_core.py) run as K4 `pbs_step_single_cta` and K6's
`ntt_mac_prime` run on it (tfhe_tpu_torch/ops/csrc/ntt_core_kernels.cuh),
checked word for word on the CPU.

K4's model makes the digits as each thread of the kernel makes its own:
coefficient j = tid + k N/8 of acc * X^a - acc by the kernel's
`rotated_diff` and its signed decomposition by `decompose_word`, in uint64
arithmetic, then runs K2's cluster model (every prime's transforms, MAC and
inverse, the explicit CRT).  K6's model runs one prime's transforms and
scales the outputs by N^-1 read from the header of that prime's pass table,
canonical.  Checked: K4's model equals `pbs_step_plain` and K6's equals
`ntt_mac_prime_plain` for every prime at the four tests/test_fused_pbs.py
cases; and through a blind rotation whose every step (scan1w) or every
per-prime stage (scan3) is the model, the reference's own Pallas
`fused_blind_rotate_scan1w` and `fused_blind_rotate_scan`, interpreted on
the CPU."""

import numpy as np
import pytest
import torch

from tfhe_tpu.ops import fused_pbs as ref_fused

from tfhe_tpu_torch import core
from tfhe_tpu_torch.ops import fused_pbs, ntt
from tfhe_tpu_torch.ops.torus import to_numpy, to_tensor
from test_torch_cases import CASES, IDS, rand_inputs
from test_torch_ntt_core import (M32, Core, model_external_product,
                                 prime_product)

U1 = np.uint64(1)


def rotated_diff(acc, a, bits):
    """acc [B, G, N] uint64, a [B] in [0, 2N] -> coefficient j of
    acc * X^a - acc at every j, as the kernel computes one: t = (j - a) mod
    2N, +-acc[t mod N], negated past N, minus acc[j], masked."""
    B, G, N = acc.shape
    a = a.astype(np.int64) & (2 * N - 1)
    t = (np.arange(N)[None, :] - a[:, None]) & (2 * N - 1)  # [B, N]
    v = np.take_along_axis(acc, np.broadcast_to((t & (N - 1))[:, None],
                                                acc.shape), axis=2)
    v = np.where((t >= N)[:, None], np.uint64(0) - v, v)
    mask = np.uint64(2**bits - 1)
    return (v - acc) & mask


def decompose_word(diff, base_log, levels, bits):
    """diff [...] uint64 -> [levels, ...] int32 signed digits, level 0 the
    largest, as the kernel's `decompose_word`: round to the representable
    multiple, then base_log bits at a time with the balancing carry."""
    mask = np.uint64(2**bits - 1)
    non_rep = np.uint64(bits - base_log * levels)
    res = ((diff >> (non_rep - U1)) + U1) & ~U1
    res = (res << (non_rep - U1)) & mask
    state = res >> non_rep
    bl = np.uint64(base_log)
    bmask = (U1 << bl) - U1
    out = np.empty((levels,) + diff.shape, np.int32)
    for k in range(levels):
        r = state & bmask
        state = state >> bl
        carry = (((r - U1) | state) & r) >> (bl - U1)
        state = state + carry
        out[levels - 1 - k] = (r.astype(np.int64)
                               - (carry.astype(np.int64) << base_log))
    return out


def model_digits(acc, ahat, base_log, levels, bits):
    """K4's digits, each made at its own word: [B, L, G, N] int32."""
    diff = rotated_diff(to_numpy(acc, bits).astype(np.uint64),
                        ahat.numpy(), bits)
    dig = decompose_word(diff, base_log, levels, bits)  # [L, B, G, N]
    return torch.from_numpy(np.ascontiguousarray(dig.transpose(1, 0, 2, 3)))


def model_step(acc, ahat, kspec, kshoup, base_log, levels, bits=64):
    """K4 as the kernel computes it: the digits of the thread's own words,
    then K2's cluster (every prime's product, the explicit CRT)."""
    return model_external_product(
        model_digits(acc, ahat, base_log, levels, bits), kspec, kshoup, acc,
        bits)


def model_prime(digits, kspec_p, kshoup_p, prime_index, residues):
    """K6's per-prime stage as the kernel computes it: one prime's product,
    scaled by N^-1 (the pass table's header words 4 and 5), canonical, into
    that prime's rows of residues [B, O, M, P, N]."""
    B, L, G, N = digits.shape
    LJ, O, M, _ = kspec_p.shape
    c = Core(N, prime_index)
    head = ntt.pass_tables_for(N, "cpu")[prime_index].to(torch.int64) & M32
    ninv, ninv_sh = int(head[4]), int(head[5])
    out = prime_product(c, digits, kspec_p, kshoup_p)  # [B, OM, N]
    residues[:, :, :, prime_index] = c.canonical(out, ninv, ninv_sh).reshape(
        B, O, M, N).to(torch.int32)
    return residues


def _step_inputs(case):
    rng = np.random.default_rng(43)
    bl, bits = case["bl"], case["bits"]
    bsk_std, lut, lwe = rand_inputs(rng, *(case[k] for k in "nLGNB"), bits)
    key = core.prepare_bsk_cuda(to_tensor(bsk_std, "cpu"), bl, bits)
    L, G, N = case["L"], case["G"], case["N"]
    acc = to_tensor(rng.integers(0, 2**bits - 1, (5, G, N), dtype=np.uint64,
                                 endpoint=True), "cpu")
    ahat = torch.from_numpy(rng.integers(0, 2 * N, (5,), endpoint=True)
                            .astype(np.int32))
    ahat[0] = 2 * N  # rotates as 0
    return key, acc, ahat, (bsk_std, lut, lwe)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_pass_table_header_holds_n_inverse(case):
    N = case["N"]
    head = ntt.pass_tables_for(N, "cpu")[:, :ntt.PASS_HEADER].to(
        torch.int64) & M32
    p = ntt.tables_for(N, "cpu").primes
    assert torch.equal(head[:, 4] * N % p, torch.ones_like(p))
    assert torch.equal(head[:, 5], (head[:, 4] << 32) // p)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_step_model_equals_plain_and_the_reference(case, monkeypatch):
    key, acc, ahat, (bsk_std, lut, lwe) = _step_inputs(case)
    bl, L, bits = case["bl"], case["L"], case["bits"]
    assert torch.equal(
        model_digits(acc, ahat, bl, L, bits),
        fused_pbs.rotate_decompose_plain(acc, ahat, bl, L, bits))
    assert torch.equal(
        model_step(acc, ahat, key.kspec[0], key.kshoup[0], bl, L, bits),
        fused_pbs.pbs_step_plain(acc, ahat, key.kspec[0], bl, L, bits))

    # a blind rotation in scan1w whose every K4 step is the model, against
    # the reference's scan1w Pallas kernel in interpret mode
    monkeypatch.setattr(fused_pbs, "pbs_step_single_cta", model_step)
    got = core.blind_rotate(key, to_tensor(lut, "cpu"), to_tensor(lwe, "cpu"),
                            mode="scan1w")
    monkeypatch.setenv("TFHE_TPU_FUSED_MODE", "scan1w")
    want = np.asarray(ref_fused.blind_rotate_fused(
        ref_fused.prepare_bsk_fused(bsk_std, bl, bits=bits), lut, lwe))
    assert np.array_equal(to_numpy(got, bits), want)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_prime_stage_model_equals_plain_and_the_reference(case, monkeypatch):
    key, acc, ahat, (bsk_std, lut, lwe) = _step_inputs(case)
    bl, L, G, N, bits = (case[k] for k in ("bl", "L", "G", "N", "bits"))
    M, P = (2 if bits == 64 else 1), len(ntt.PRIMES)
    dig = fused_pbs.rotate_decompose_plain(acc, ahat, bl, L, bits)
    got = torch.full((acc.shape[0], G, M, P, N), -1, dtype=torch.int32)
    want = torch.full_like(got, -1)
    for pi in range(P):
        model_prime(dig, key.kspec[0, pi], key.kshoup[0, pi], pi, got)
        fused_pbs.ntt_mac_prime_plain(dig, key.kspec[0, pi], pi, want)
        assert torch.equal(got, want), pi

    # a blind rotation in scan3 whose every per-prime stage is the model,
    # against the reference's scan3 Pallas kernels in interpret mode
    monkeypatch.setattr(fused_pbs, "ntt_mac_prime", model_prime)
    got = core.blind_rotate(key, to_tensor(lut, "cpu"), to_tensor(lwe, "cpu"),
                            mode="scan3")
    monkeypatch.setenv("TFHE_TPU_FUSED_MODE", "scan3")
    want = np.asarray(ref_fused.blind_rotate_fused(
        ref_fused.prepare_bsk_fused(bsk_std, bl, bits=bits), lut, lwe))
    assert np.array_equal(to_numpy(got, bits), want)
