"""The plain versions of the port's two blind-rotation kernels == tfhe_tpu's
rotation + decomposition and CRT-NTT external product, bit for bit, for one
step at the tests/test_fused_pbs.py cases; the whole blind rotation is in
test_torch_blind_rotate.py."""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from tfhe_tpu.ops import decomposition as ref_dec
from tfhe_tpu.ops import polymul as ref_poly
from tfhe_tpu.ops.polymul_ntt import external_product_ntt, prepare_bsk_ntt

from tfhe_tpu_torch.ops import fused_pbs
from tfhe_tpu_torch.ops.torus import to_numpy, to_tensor
from test_torch_cases import CASES, IDS, rand_inputs


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_one_step_matches_reference(case):
    rng = np.random.default_rng(42)
    n, L, G, N, B = case["n"], case["L"], case["G"], case["N"], case["B"]
    bl, bits = case["bl"], case["bits"]
    bsk_std, _, _ = rand_inputs(rng, n, L, G, N, B, bits)
    dt = bsk_std.dtype
    acc = rng.integers(0, np.iinfo(dt).max, (B, G, N), dtype=dt)
    ahat = rng.integers(0, 2 * N, (B,), endpoint=True).astype(np.int32)
    ahat[:2] = [0, 2 * N]

    rotated = ref_poly.monomial_mul(acc, ahat[:, None], N, bits=bits)
    ct1 = rotated - jnp.asarray(acc)
    want_dig = np.asarray(ref_dec.signed_decompose(ct1, bl, L, bits=bits))
    ref_key = prepare_bsk_ntt(bsk_std, bl, bits=bits)
    ext = jax.jit(partial(external_product_ntt, base_log=bl, levels=L,
                          bits=bits))
    delta = ext(ct1, ref_key.spectra[0], ref_key.shoup[0],
                fwd_mats=ref_key.fwd_mats, inv_mats=ref_key.inv_mats)
    want_acc = np.asarray(jnp.asarray(acc) + delta)

    acc_t = to_tensor(acc, "cpu")
    dig = fused_pbs.rotate_decompose_plain(acc_t, torch.from_numpy(ahat), bl,
                                           L, bits)
    assert dig.shape == (B, L, G, N) and dig.dtype == torch.int32
    assert np.array_equal(dig.numpy(), want_dig.transpose(0, 3, 1, 2))
    key = fused_pbs.prepare_bsk_cuda(to_tensor(bsk_std, "cpu"), bl, bits)
    got = fused_pbs.external_product_crt_plain(dig, key.kspec[0], acc_t, bits,
                                               primes=key.primes)
    assert np.array_equal(to_numpy(got, bits), want_acc)


def test_wrappers_take_the_plain_version_for_cpu_tensors_only():
    rng = np.random.default_rng(3)
    N, G, L, bl = 256, 2, 1, 23
    acc = to_tensor(rng.integers(0, 2**63, (4, G, N), dtype=np.uint64), "cpu")
    ahat = torch.from_numpy(rng.integers(0, 2 * N, (4,)).astype(np.int32))
    key = fused_pbs.prepare_bsk_cuda(
        to_tensor(rng.integers(0, 2**63, (1, L, G, G, N), dtype=np.uint64),
                  "cpu"), bl)
    ps = {"primes": key.primes}
    P, M = len(key.primes), key.planes
    fused_pbs.reset_launch_counts()
    dig = fused_pbs.rotate_decompose(acc, ahat, bl, L)
    assert torch.equal(dig, fused_pbs.rotate_decompose_plain(acc, ahat, bl, L))
    out = fused_pbs.external_product_crt(dig, key.kspec[0], key.kshoup[0], acc,
                                         **ps)
    assert torch.equal(out, fused_pbs.external_product_crt_plain(
        dig, key.kspec[0], acc, **ps))
    step = fused_pbs.pbs_step(acc, ahat, key.kspec[0], key.kshoup[0], bl, L,
                              **ps)
    assert torch.equal(step, fused_pbs.pbs_step_plain(acc, ahat, key.kspec[0],
                                                      bl, L, **ps))
    rot = fused_pbs.blind_rotate_persistent(acc, ahat[None], key.kspec,
                                            key.kshoup, bl, L, **ps)
    assert torch.equal(rot, step)
    res = torch.zeros((4, G, M, P, N), dtype=torch.int32)
    for pi in range(P):
        fused_pbs.ntt_mac_prime(dig, key.kspec[0, pi], key.kshoup[0, pi], pi,
                                res, **ps)
    assert torch.equal(fused_pbs.crt_accumulate(res, acc, **ps), out)
    assert [k.launches for k in fused_pbs.KERNELS] == [0] * len(
        fused_pbs.KERNELS)
    with pytest.raises(ValueError):
        fused_pbs.rotate_decompose(acc.to("meta"), ahat.to("meta"), bl, L)
    with pytest.raises(ValueError):
        fused_pbs.external_product_crt(dig.to("meta"), key.kspec[0].to("meta"),
                                       key.kshoup[0].to("meta"),
                                       acc.to("meta"), **ps)
    meta_key = (key.kspec[0].to("meta"), key.kshoup[0].to("meta"))
    with pytest.raises(ValueError):
        fused_pbs.pbs_step(acc.to("meta"), ahat.to("meta"), *meta_key, bl, L,
                           **ps)
    with pytest.raises(ValueError):
        fused_pbs.blind_rotate_persistent(
            acc.to("meta"), ahat[None].to("meta"), key.kspec.to("meta"),
            key.kshoup.to("meta"), bl, L, **ps)
    with pytest.raises(ValueError):
        fused_pbs.ntt_mac_prime(dig.to("meta"), meta_key[0][0],
                                meta_key[1][0], 0, res.to("meta"), **ps)
    with pytest.raises(ValueError):
        fused_pbs.crt_accumulate(res.to("meta"), acc.to("meta"), **ps)
