"""A plain model of K1 `rotate_decompose` as its CUDA threads run it
(tfhe_tpu_torch/ops/csrc/pbs_kernels.cuh `rotate_decompose_kernel`, the
launch geometry of `tfhe_rotate_decompose` in pbs_kernels.cu), checked
word for word on the CPU against `rotate_decompose_plain` and the
reference's `_rot_dec_limbs` math.

The launch: blocks of 256 threads, min(N/4, 256) along a row (tx) and the
rest over ciphertexts (ty), the GLWE polynomial on grid.y and the row's
chunks of 4 tx_count words on grid.z.  Thread (tx, ty) of block (x, g, z)
owns ciphertext b = x ty_count + ty and the coefficients j0 ... j0 + 3,
j0 = 4 (z tx_count + tx).  It reads its own
words, then the rotated source word by word, t = (j - a) mod 2N with
a = ahat mod 2N (2N is the identity), +-acc[t mod N] (negated past N),
forms the 4 differences masked to the torus width, decomposes them in lock
step (the kernel's `decompose_words`, the same arithmetic as
`decompose_word` on each), and writes each level's 4 digits at
digits[b, level, g, j0 ... j0 + 3].  Checked: the threads of the launch
cover every (b, g, word) exactly once, ragged last blocks included; and the
model's digits equal `rotate_decompose_plain`'s at both torus widths, with
a = 0, a = 2N and wrapping rotations, at N = 4 ... 2048."""

import numpy as np
import pytest
import torch

from tfhe_tpu_torch.ops import fused_pbs
from test_torch_ntt_core_steps import decompose_word

WORDS = 4  # tfhe_pbs::kRotWords
BLOCK = 256


def launch_units(B, G, N):
    """(b, g, j0) of every 4-word unit the launch's threads own, in thread
    order, with the grid the launcher makes."""
    tx_count = min(N // WORDS, BLOCK)
    ty_count = BLOCK // tx_count
    grid = (-(-B // ty_count), G, N // WORDS // tx_count)
    units = []
    for x in range(grid[0]):
        for g in range(grid[1]):
            for z in range(grid[2]):
                for ty in range(ty_count):
                    b = x * ty_count + ty
                    if b >= B:
                        continue
                    for tx in range(tx_count):
                        units.append((b, g, WORDS * (z * tx_count + tx)))
    return np.array(units, dtype=np.int64).reshape(-1, 3)


def model_rotate_decompose(acc, ahat, base_log, levels, bits):
    """K1 as its threads compute it: acc [B, G, N] int64, ahat [B] int32 in
    [0, 2N] -> digits [B, L, G, N] int32."""
    B, G, N = acc.shape
    mask = np.uint64(2**bits - 1)
    words = acc.numpy().view(np.uint64)
    units = launch_units(B, G, N)
    b, g, j0 = units.T
    j = j0[:, None] + np.arange(WORDS)  # [U, 4]
    a = ahat.numpy().astype(np.int64)[b] & (2 * N - 1)
    t = (j - a[:, None]) & (2 * N - 1)
    row = words[b, g]  # [U, N]
    own = np.take_along_axis(row, j, axis=1)
    v = np.take_along_axis(row, t & (N - 1), axis=1)
    v = np.where(t >= N, np.uint64(0) - v, v)
    dg = decompose_word((v - own) & mask, base_log, levels, bits)  # [L,U,4]
    out = np.full((B, levels, G, N), -(2**31), np.int32)
    for lvl in range(levels):
        out[b[:, None], lvl, g[:, None], j] = dg[lvl]
    return torch.from_numpy(out)


@pytest.mark.parametrize("B,G,N", [(1, 2, 2048), (9, 2, 2048), (3, 3, 512),
                                   (70, 2, 256), (33, 2, 64), (5, 2, 8),
                                   (3, 2, 4), (2, 4, 4096)])
def test_threads_cover_every_word_once(B, G, N):
    units = launch_units(B, G, N)
    keys = (units[:, 0] * G + units[:, 1]) * N + units[:, 2]
    assert np.all(units[:, 2] % WORDS == 0)
    assert np.array_equal(np.sort(keys), np.arange(0, B * G * N, WORDS))


# (B, G, N, base_log, levels, bits): PARAM_MESSAGE_2_CARRY_2_KS_PBS and
# boolean DEFAULT_PARAMETERS widths (small batches), the TEST sets' and the
# cases' N = 256, and N = 64 and 8 (fewer than 32 threads a row)
WIDTHS = [(3, 2, 2048, 23, 1, 64), (5, 3, 512, 6, 3, 32),
          (9, 2, 256, 15, 1, 64), (4, 3, 256, 6, 3, 32),
          (40, 2, 64, 8, 2, 64), (3, 2, 8, 4, 4, 32)]
WIDTH_IDS = ["shortint", "boolean", "n256_u64", "n256_u32", "n64", "n8"]


@pytest.mark.parametrize("width", WIDTHS, ids=WIDTH_IDS)
def test_model_equals_plain(width):
    B, G, N, bl, L, bits = width
    rng = np.random.default_rng(list(width))
    acc = torch.from_numpy(rng.integers(
        0, 2**bits - 1, (B, G, N), dtype=np.uint64, endpoint=True)
        .view(np.int64))
    ahat = rng.integers(0, 2 * N, B, endpoint=True)
    # the identities a = 0 and a = 2N, then a rotation that wraps at N
    # inside a thread's 4 words (a = 3) and one that wraps at 2N (a = N + 5)
    ahat[:4] = [0, 2 * N, 3, N + 5][:min(B, 4)]
    ahat = torch.from_numpy(ahat.astype(np.int32))
    got = model_rotate_decompose(acc, ahat, bl, L, bits)
    assert torch.equal(got, fused_pbs.rotate_decompose_plain(acc, ahat, bl, L,
                                                             bits))
