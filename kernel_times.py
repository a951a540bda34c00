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
width (gf=3).  Only functions that both trees of the port have are called.
Prints one JSON line, with the card's name and power limit.
"""

import argparse
import json
import os
import sys

from chip_smoke import B_MAIN, SEED, card_line, graph_ms


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
    return {k: graph_ms(fn, 100) for k, fn in calls.items()}


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
    fused_multibit.cuda_library()
    out = {str(s): times(s) for s in args.seeds}
    print(json.dumps({"card": card_line(), "root": args.root,
                      "device_ms_per_launch": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
