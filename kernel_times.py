"""Device times of the classic and multi-bit kernels on fixed inputs, to
compare two trees of tfhe_tpu_torch on one card.

    python3 kernel_times.py [--root DIR] [--seeds 2024 1 2 3]
                            [--no-rotations]

DIR is the directory holding the tfhe_tpu_torch to time (default: this
script's).  Every tree gets the same inputs: for each seed, the multi-bit
inputs are drawn from numpy's default_rng(seed) as chip_smoke.py's
`multibit_kernels_phase` draws them, and the classic inputs from a fresh
default_rng(seed) as its `modes_kernels_phase` draws them at
PARAM_MESSAGE_2_CARRY_2_KS_PBS's width, so seed 2024 gives the smoke's own
inputs.  Timed at B = 64, each as a CUDA graph of 100 launches replayed
three times between CUDA events: K1 `rotate_decompose` and K2
`external_product_crt` (N=2048, G=2, L=1, base_log 23, u64), and at
PARAM_MULTI_BIT_MESSAGE_2_CARRY_2_GROUP_3_KS_PBS's width (gf=3) K8's
`multibit_combine` and its external product from the accumulator
(`multibit_external_product_from_acc`: the digits and the product, as
the tree makes them: `decompose` then the product of the digits, or the
product taking the accumulator).  K9 and K8 are timed as a whole group
step: `multi_bit_blind_rotate_cuda` over one group in mode "scan1"
(`multibit_group_step`) and "scan3" (`multibit_scan3_group_step`),
whatever launches the tree makes for it; `*_B256` the same at B = 256
(inputs from default_rng([seed, 256])).  Then, from a generator of their
own per seed and width (default_rng([seed, n])), K1 and K2 at boolean
DEFAULT_PARAMETERS' width (N=512, G=3, L=3, base_log 6, u32) and both
widths at B = 256, and at both widths and B = 64 and 256 K3 `pbs_step`
and K4 `pbs_step_single_cta` (one step each), K7
`blind_rotate_single_cta` over one step (the kernel K7's launcher picks
for that batch; CUDA events around 100 eager launches, as its launcher
queries the device), K6's `ntt_mac_prime` for prime 0 and its
`crt_accumulate` on the step's residues of all five primes (graphs of
100), and K5 `blind_rotate_persistent` and K7 a whole rotation at the
main path's depth (742 and 722 steps; CUDA events around 3 launches after
2 warm-ups).  Then K10's whole step, `polymul_ntt.spectral_mac` over the
five primes (whatever launches the tree makes for it), at the widths of
the CRT-NTT layout's three paths (shortint, boolean, u128) and B = 64 and
256, from default_rng([seed, 10, B]) (graphs of 100).  --no-rotations
leaves out the whole rotations of K5 and K7, most of the run's time, to
compare forms of the other kernels.  Only functions that both trees of
the port have are called.  Prints one JSON line, with the
card's name and power limit.
"""

import argparse
import dataclasses
import json
import os
import sys

from chip_smoke import B_LARGE, B_MAIN, SEED, card_line, cuda_ms, graph_ms


def times(seed, rotations=True):
    import numpy as np
    import torch

    from tfhe_tpu_torch.ops import fused_multibit as fm
    from tfhe_tpu_torch.ops import fused_pbs as fp
    from tfhe_tpu_torch.params import (
        PARAM_MESSAGE_2_CARRY_2_KS_PBS as cp,
        PARAM_MULTI_BIT_MESSAGE_2_CARRY_2_GROUP_3_KS_PBS as mp)

    dev = torch.device("cuda")

    def rand_u64(rng, *shape):
        return torch.from_numpy(
            rng.integers(0, 2**64 - 1, shape, dtype=np.uint64,
                         endpoint=True).view(np.int64)).to(dev)

    rng = np.random.default_rng(seed)
    N, G, L, bl, gf = (mp.polynomial_size, mp.glwe_size, mp.pbs_level,
                       mp.pbs_base_log, mp.grouping_factor)
    N_MB, G_MB = N, G
    per = 1 << gf
    mkey = fm.prepare_multi_bit_bsk_cuda(rand_u64(rng, 2, per, L, G, G, N),
                                         bl, gf)
    macc = rand_u64(rng, B_MAIN, G, N)
    d = torch.from_numpy(rng.integers(0, 2 * N, (2, B_MAIN, per))
                         .astype(np.int32)).to(dev)
    d[:, :, 0] = 0
    ks = mkey.kspec[0]
    comb = fm.multibit_combine_plain(d[0], ks)
    mbl, mL = bl, L
    one_group = dataclasses.replace(mkey, input_dim=gf)
    if hasattr(fm, "decompose"):  # a tree whose product takes digits
        def product_from_acc():
            return fm.multibit_external_product(fm.decompose(macc, mbl, mL),
                                                comb)
    else:
        def product_from_acc():
            return fm.multibit_external_product(macc, comb, mbl, mL)

    rng = np.random.default_rng(seed)
    N, G, L, bl = (cp.polynomial_size, cp.glwe_size, cp.pbs_level,
                   cp.pbs_base_log)
    key = fp.prepare_bsk_cuda(rand_u64(rng, 4, L, G, G, N), bl)
    acc = rand_u64(rng, B_MAIN, G, N)
    ahat = torch.from_numpy(rng.integers(0, 2 * N, (4, B_MAIN), endpoint=True)
                            .astype(np.int32)).to(dev)
    dig = fp.rotate_decompose_plain(acc, ahat[0], bl, L)

    calls = {
        "rotate_decompose": lambda: fp.rotate_decompose(acc, ahat[0], bl, L),
        "external_product_crt": lambda: fp.external_product_crt(
            dig, key.kspec[0], key.kshoup[0], acc),
        "multibit_combine": lambda: fm.multibit_combine(d[0], ks),
        "multibit_external_product_from_acc": product_from_acc,
        "multibit_group_step": lambda: fm.multi_bit_blind_rotate_cuda(
            one_group, macc, d[:1], mode="scan1"),
        "multibit_scan3_group_step": lambda: fm.multi_bit_blind_rotate_cuda(
            one_group, macc, d[:1], mode="scan3"),
    }
    out = {k: graph_ms(fn, 100) for k, fn in calls.items()}
    rng = np.random.default_rng([seed, B_LARGE])
    macc = rand_u64(rng, B_LARGE, G_MB, N_MB)
    d = torch.from_numpy(rng.integers(0, 2 * N_MB, (1, B_LARGE, per))
                         .astype(np.int32)).to(dev)
    d[:, :, 0] = 0
    for mode, name in (("scan1", "multibit_group_step"),
                       ("scan3", "multibit_scan3_group_step")):
        out[f"{name}_B256"] = graph_ms(
            lambda: fm.multi_bit_blind_rotate_cuda(  # noqa: B023
                one_group, macc, d, mode=mode), 100)
    out.update(redesigned(seed, rotations))
    out.update(ntt_step(seed))
    return out


def redesigned(seed, rotations=True):
    """K1 and K2 at both widths and B = 64 / 256 (the shortint width at
    B = 64 is timed above); K3 and K4 (one step each), K7 over one step,
    K6's `ntt_mac_prime` (prime 0) and its `crt_accumulate` (on the step's
    residues) at both widths and batch sizes; and,
    with `rotations`, K5 and K7 at both widths, depths and batch sizes."""
    import numpy as np
    import torch

    from tfhe_tpu_torch.ops import fused_pbs as fp
    from tfhe_tpu_torch.params import (
        DEFAULT_PARAMETERS, PARAM_MESSAGE_2_CARRY_2_KS_PBS)

    dev = torch.device("cuda")
    out = {}
    for p, tag in ((PARAM_MESSAGE_2_CARRY_2_KS_PBS, "shortint"),
                   (DEFAULT_PARAMETERS, "boolean")):
        N, G, L, bl, bits, n = (p.polynomial_size, p.glwe_size, p.pbs_level,
                                p.pbs_base_log, p.torus_bits,
                                p.lwe_dimension)
        rng = np.random.default_rng([seed, n])

        def words(*shape):
            return torch.from_numpy(rng.integers(  # noqa: B023
                0, 2**bits - 1, shape, dtype=np.uint64, endpoint=True)
                .view(np.int64)).to(dev)

        key = fp.prepare_bsk_cuda(words(n, L, G, G, N), bl, bits)
        for B in (B_MAIN, B_LARGE):
            acc = words(B, G, N)
            ahat = torch.from_numpy(rng.integers(0, 2 * N, (n, B),
                                                 endpoint=True)
                                    .astype(np.int32)).to(dev)
            dig = fp.rotate_decompose_plain(acc, ahat[0], bl, L, bits)
            if (tag, B) != ("shortint", B_MAIN):
                out[f"rotate_decompose_{tag}_B{B}"] = graph_ms(
                    lambda: fp.rotate_decompose(  # noqa: B023
                        acc, ahat[0], bl, L, bits), 100)
                out[f"external_product_crt_{tag}_B{B}"] = graph_ms(
                    lambda: fp.external_product_crt(  # noqa: B023
                        dig, key.kspec[0], key.kshoup[0], acc, bits), 100)
            # K3 and K4 (one step each), K7's form of one step (one CTA or
            # a cluster per ciphertext, as blind_rotate_single_cta_form
            # picks), and K6's ntt_mac_prime for prime 0
            res = torch.empty((B, G, 2 if bits == 64 else 1, 5, N),
                              dtype=torch.int32, device=dev)
            out[f"pbs_step_{tag}_B{B}"] = graph_ms(
                lambda: fp.pbs_step(  # noqa: B023
                    acc, ahat[0], key.kspec[0], key.kshoup[0], bl, L, bits),
                100)
            out[f"pbs_step_single_cta_{tag}_B{B}"] = graph_ms(
                lambda: fp.pbs_step_single_cta(  # noqa: B023
                    acc, ahat[0], key.kspec[0], key.kshoup[0], bl, L, bits),
                100)
            out[f"blind_rotate_single_cta_1step_{tag}_B{B}"] = cuda_ms(
                lambda: fp.blind_rotate_single_cta(  # noqa: B023
                    acc, ahat[:1], key.kspec[:1], key.kshoup[:1], bl, L,
                    bits), 100)
            out[f"ntt_mac_prime_{tag}_B{B}"] = graph_ms(
                lambda: fp.ntt_mac_prime(  # noqa: B023
                    dig, key.kspec[0, 0], key.kshoup[0, 0], 0, res), 100)
            # K6's crt_accumulate on this step's residues, every prime's
            for pi in range(5):
                fp.ntt_mac_prime(dig, key.kspec[0, pi], key.kshoup[0, pi],
                                 pi, res)
            out[f"crt_accumulate_{tag}_B{B}"] = graph_ms(
                lambda: fp.crt_accumulate(res, acc, bits),  # noqa: B023
                100)
            if not rotations:
                continue
            out[f"blind_rotate_single_cta_{tag}_B{B}"] = cuda_ms(
                lambda: fp.blind_rotate_single_cta(  # noqa: B023
                    acc, ahat, key.kspec, key.kshoup, bl, L, bits), 3)
            out[f"blind_rotate_persistent_{tag}_B{B}"] = cuda_ms(
                lambda: fp.blind_rotate_persistent(  # noqa: B023
                    acc, ahat, key.kspec, key.kshoup, bl, L, bits), 3)
        del key
        torch.cuda.empty_cache()
    return out


# K10's three widths: (name, L, J = G, O = G, M planes, N)
NTT_WIDTHS = (("shortint", 1, 2, 2, 2, 2048), ("boolean", 3, 3, 3, 1, 512),
              ("u128", 1, 2, 2, 4, 2048))


def ntt_step(seed):
    """K10's whole step, `polymul_ntt.spectral_mac` over the five primes,
    at the three widths and B = 64 / 256."""
    import numpy as np
    import torch

    from tfhe_tpu_torch.ops import ntt
    from tfhe_tpu_torch.ops import polymul_ntt as pn

    dev = torch.device("cuda")
    out = {}
    for tag, L, J, O, M, N in NTT_WIDTHS:
        for B in (B_MAIN, B_LARGE):
            rng = np.random.default_rng([seed, 10, B])
            h = np.array(ntt.PRIMES).reshape(-1, 1, 1, 1) // 2
            dspec = torch.from_numpy(rng.integers(
                -h, h + 1, (len(ntt.PRIMES), B, L * J, N)).astype(
                    np.int32)).to(dev)
            spec = torch.from_numpy(rng.integers(
                -h[..., None, None, None], h[..., None, None, None] + 1,
                (len(ntt.PRIMES), L, J, O, M, N)).astype(np.int32)).to(dev)
            shoup = torch.stack([ntt.shoup16(spec[i], p)
                                 for i, p in enumerate(ntt.PRIMES)])
            out[f"spectral_mac_{tag}_B{B}"] = graph_ms(
                lambda: pn.spectral_mac(  # noqa: B023
                    dspec, spec, shoup), 100)
    return out


def main():
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=here)
    ap.add_argument("--seeds", type=int, nargs="+", default=[SEED, 1, 2, 3])
    ap.add_argument("--no-rotations", dest="rotations", action="store_false",
                    help="leave out K5's and K7's whole rotations")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from tfhe_tpu_torch.ops import fused_multibit, fused_pbs, shoup_mac

    fused_pbs.cuda_library()
    fused_pbs.single_cta_library()
    fused_multibit.cuda_library()
    shoup_mac.cuda_library()
    out = {str(s): times(s, args.rotations) for s in args.seeds}
    print(json.dumps({"card": card_line(), "root": args.root,
                      "device_ms_per_launch": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
