"""Device times of the classic and multi-bit kernels on fixed inputs, to
compare two trees of tfhe_tpu_torch on one card.

    python3 kernel_times.py [--root DIR] [--seeds 2024 1 2 3]

DIR is the directory holding the tfhe_tpu_torch to time (default: this
script's).  Every tree gets the same inputs: for each seed, the multi-bit
inputs are drawn from numpy's default_rng(seed) as chip_smoke.py's
`multibit_kernels_phase` draws them, and the classic inputs from a fresh
default_rng(seed) as its `modes_kernels_phase` draws them at
PARAM_MESSAGE_2_CARRY_2_KS_PBS's width, so seed 2024 gives the smoke's own
inputs.  Timed at B = 64, each as a CUDA graph of 100 launches replayed
three times between CUDA events: K1 `rotate_decompose` and K2
`external_product_crt` (N=2048, G=2, L=1, base_log 23, u64), and K8
(`decompose`, `multibit_combine`, `multibit_external_product`) and K9
`multibit_step` at PARAM_MULTI_BIT_MESSAGE_2_CARRY_2_GROUP_3_KS_PBS's
width (gf=3).  Then, from a generator of their own per seed and width
(default_rng([seed, n])), K2 at boolean DEFAULT_PARAMETERS' width (N=512,
G=3, L=3, base_log 6, u32) and both widths at B = 256, and at both
widths and B = 64 and 256 K4 `pbs_step_single_cta` (one step), K7
`blind_rotate_single_cta` over one step (the kernel K7's launcher picks
for that batch; CUDA events around 100 eager launches, as its launcher
queries the device) and K6's `ntt_mac_prime` for prime 0 (graphs of
100), and K7 a whole rotation at the main path's depth (742 and 722
steps; CUDA events around 3 launches after 2 warm-ups).  Only functions
that both trees of the port have are called.  Prints one JSON line, with
the card's name and power limit.
"""

import argparse
import json
import os
import sys

from chip_smoke import B_LARGE, B_MAIN, SEED, card_line, cuda_ms, graph_ms


def times(seed):
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
    per = 1 << gf
    mkey = fm.prepare_multi_bit_bsk_cuda(rand_u64(rng, 2, per, L, G, G, N),
                                         bl, gf)
    macc = rand_u64(rng, B_MAIN, G, N)
    d = torch.from_numpy(rng.integers(0, 2 * N, (2, B_MAIN, per))
                         .astype(np.int32)).to(dev)
    d[:, :, 0] = 0
    ks, ksh = mkey.kspec[0], mkey.kshoup[0]
    mdig = fm.decompose_plain(macc, bl, L)
    comb = fm.multibit_combine_plain(d[0], ks)
    mbl, mL = bl, L

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
        "decompose": lambda: fm.decompose(macc, mbl, mL),
        "multibit_combine": lambda: fm.multibit_combine(d[0], ks),
        "multibit_external_product": lambda: fm.multibit_external_product(
            mdig, comb),
        "multibit_step": lambda: fm.multibit_step(mdig, d[0], ks, ksh),
    }
    out = {k: graph_ms(fn, 100) for k, fn in calls.items()}
    out.update(redesigned(seed))
    return out


def redesigned(seed):
    """K2 at both widths and B = 64 / 256 (the shortint width at B = 64 is
    timed above); K4 (one step), K7 over one step and K6's `ntt_mac_prime`
    (prime 0) at both widths and batch sizes; and K7 at both widths, depths
    and batch sizes."""
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
                out[f"external_product_crt_{tag}_B{B}"] = graph_ms(
                    lambda: fp.external_product_crt(  # noqa: B023
                        dig, key.kspec[0], key.kshoup[0], acc, bits), 100)
            # K4 (one step), K7's form of one step (one CTA or a cluster
            # per ciphertext, as blind_rotate_single_cta_form picks), and
            # K6's ntt_mac_prime for prime 0
            res = torch.empty((B, G, 2 if bits == 64 else 1, 5, N),
                              dtype=torch.int32, device=dev)
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
            out[f"blind_rotate_single_cta_{tag}_B{B}"] = cuda_ms(
                lambda: fp.blind_rotate_single_cta(  # noqa: B023
                    acc, ahat, key.kspec, key.kshoup, bl, L, bits), 3)
        del key
        torch.cuda.empty_cache()
    return out


def main():
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=here)
    ap.add_argument("--seeds", type=int, nargs="+", default=[SEED, 1, 2, 3])
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from tfhe_tpu_torch.ops import fused_multibit, fused_pbs

    fused_pbs.cuda_library()
    fused_pbs.single_cta_library()
    fused_multibit.cuda_library()
    out = {str(s): times(s) for s in args.seeds}
    print(json.dumps({"card": card_line(), "root": args.root,
                      "device_ms_per_launch": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
