"""The core's wide variants, WoPBS and public-key encryption on a card ==
their plain versions and the port on the CPU, word for word (tolerance 0):
K1 and every classic kernel on the core (K2, ntt_mac_prime, K3, K4, and
K5 and K7 over 3 steps) at L*G = 12 and 18 against their plain versions;
K1 and K2 at every PBS layout of the WoPBS catalog; a WoPBS at WOPBS_PARAM_MESSAGE_2_CARRY_2_TEST and a public-key encryption
at PARAM_MESSAGE_2_CARRY_2_TEST from one seed on both devices.  Marked
`cuda`: it skips where there is no card; on one, run `python -m pytest -m
cuda --noconftest tests/test_torch_wopbs_cuda.py` (tests/conftest.py
imports JAX, which is not needed here)."""

import dataclasses

import numpy as np
import pytest
import torch

from tfhe_tpu_torch import shortint
from tfhe_tpu_torch.ops import fused_pbs as fp
from tfhe_tpu_torch.params import (PARAM_MESSAGE_2_CARRY_2_TEST,
                                   WOPBS_PARAM_MESSAGE_2_CARRY_2_TEST,
                                   wopbs_params)

pytestmark = pytest.mark.cuda

SEED = 2024
WIDE = ("PARAM_4_BITS_5_BLOCKS", "WOPBS_PARAM_MESSAGE_1_NORM2_6_KS_PBS")
# (N, k + 1, level, base_log) of every set's PBS in the catalog
LAYOUTS = sorted({(p.polynomial_size, p.glwe_size, p.pbs_level,
                   p.pbs_base_log) for p in wopbs_params.ALL})


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.parametrize("name", WIDE)
def test_wide_kernels_equal_their_plain_versions(name):
    dev = _card()
    p = getattr(wopbs_params, name)
    N, G, L, bl, P, B, steps = (p.polynomial_size, p.glwe_size, p.pbs_level,
                                p.pbs_base_log, 5, 8, 3)
    assert L * G in (12, 18)
    rng = np.random.default_rng(SEED)

    def words(*shape):
        return torch.from_numpy(rng.integers(
            0, 2**64 - 1, shape, dtype=np.uint64, endpoint=True)
            .view(np.int64)).to(dev)

    key = fp.prepare_bsk_cuda(words(steps, L, G, G, N), bl)
    acc = words(B, G, N)
    ahat = torch.from_numpy(rng.integers(0, 2 * N, (steps, B), endpoint=True)
                            .astype(np.int32)).to(dev)
    ks, ksh = key.kspec[0], key.kshoup[0]
    dig = fp.rotate_decompose_plain(acc, ahat[0], bl, L)
    assert torch.equal(fp.rotate_decompose(acc, ahat[0], bl, L), dig)
    assert torch.equal(fp.external_product_crt(dig, ks, ksh, acc),
                       fp.external_product_crt_plain(dig, ks, acc))
    res_p = torch.empty((B, G, 2, P, N), dtype=torch.int32, device=dev)
    res_k = torch.empty_like(res_p)
    for pi in range(P):
        fp.ntt_mac_prime_plain(dig, ks[pi], pi, res_p)
        fp.ntt_mac_prime(dig, ks[pi], ksh[pi], pi, res_k)
    assert torch.equal(res_k, res_p)
    step = fp.pbs_step_plain(acc, ahat[0], ks, bl, L)
    assert torch.equal(fp.pbs_step(acc, ahat[0], ks, ksh, bl, L), step)
    assert torch.equal(fp.pbs_step_single_cta(acc, ahat[0], ks, ksh, bl, L),
                       step)
    whole = fp.blind_rotate_persistent_plain(acc, ahat, key.kspec, bl, L)
    assert torch.equal(fp.blind_rotate_persistent(
        acc, ahat, key.kspec, key.kshoup, bl, L), whole)
    assert torch.equal(fp.blind_rotate_single_cta(
        acc, ahat, key.kspec, key.kshoup, bl, L), whole)


@pytest.mark.parametrize("layout", LAYOUTS,
                         ids=["N{}G{}L{}b{}".format(*t) for t in LAYOUTS])
def test_catalog_layouts_run_k1_and_k2(layout):
    # the WoPBS path's scan2 kernels at each layout the catalog's keys take
    dev = _card()
    N, G, L, bl = layout
    rng = np.random.default_rng([SEED, N, G, L, bl])

    def words(*shape):
        return torch.from_numpy(rng.integers(
            0, 2**64 - 1, shape, dtype=np.uint64, endpoint=True)
            .view(np.int64)).to(dev)

    key = fp.prepare_bsk_cuda(words(1, L, G, G, N), bl)
    acc = words(4, G, N)
    ahat = torch.from_numpy(rng.integers(0, 2 * N, (4,), endpoint=True)
                            .astype(np.int32)).to(dev)
    dig = fp.rotate_decompose_plain(acc, ahat, bl, L)
    assert torch.equal(fp.rotate_decompose(acc, ahat, bl, L), dig)
    assert torch.equal(
        fp.external_product_crt(dig, key.kspec[0], key.kshoup[0], acc),
        fp.external_product_crt_plain(dig, key.kspec[0], acc))


def test_wide_lut_batch_card_equals_cpu():
    _card()
    p = dataclasses.replace(wopbs_params.PARAM_4_BITS_5_BLOCKS,
                            lwe_dimension=16)
    outs = {}
    for where in ("cuda", "cpu"):
        cks, sks = shortint.gen_keys(p, seed=SEED, device=where)
        out = sks.apply_lookup_table_batch(
            cks.encrypt_batch(np.arange(8)),
            sks.generate_lookup_table(lambda x: (x + 3) % 16))
        np.testing.assert_array_equal(
            cks.decrypt_batch_message_and_carry(out), (np.arange(8) + 3) % 16)
        outs[where] = out.data.cpu()
    assert torch.equal(outs["cuda"], outs["cpu"])


def test_wopbs_card_equals_cpu():
    _card()
    outs = {}
    for where in ("cuda", "cpu"):
        cks, _, wk = shortint.gen_keys_wopbs(
            WOPBS_PARAM_MESSAGE_2_CARRY_2_TEST, seed=SEED, device=where)
        msgs = np.arange(16)
        out = wk.wopbs_batch(cks.encrypt_batch(msgs),
                             wk.generate_lut_full_domain(lambda x: (x * x)
                                                         % 16))
        np.testing.assert_array_equal(
            cks.decrypt_batch_message_and_carry(out), (msgs * msgs) % 16)
        outs[where] = (out.data.cpu(), wk.cbs.pfpksk_list.cpu())
    assert torch.equal(outs["cuda"][1], outs["cpu"][1])
    assert torch.equal(outs["cuda"][0], outs["cpu"][0])


def test_public_key_encryption_card_equals_cpu():
    _card()
    outs = {}
    for where in ("cuda", "cpu"):
        cks = shortint.ClientKey(PARAM_MESSAGE_2_CARRY_2_TEST, seed=SEED,
                                 device=where)
        pk = shortint.PublicKey(cks)
        batch = pk.encrypt_batch(np.arange(16), seed=7)
        np.testing.assert_array_equal(
            cks.decrypt_batch_message_and_carry(batch), np.arange(16))
        cpk = shortint.CompactPublicKey(cks)
        compact = cpk.encrypt_compact_batch(np.arange(16), seed=8).expand()
        outs[where] = (batch.data.cpu(), compact.data.cpu())
    for a, b in zip(outs["cuda"], outs["cpu"]):
        assert torch.equal(a, b)
