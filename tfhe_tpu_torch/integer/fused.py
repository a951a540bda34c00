"""Single-program radix ops: whole radix operations as one static sequence
of keyswitch + PBS batches over [B, nb, lwe_size] block tensors.

Port of the non-mesh half of `tfhe_tpu/parallel/fused.py` (`:24-406`).  The
host path (`integer/server_key.py`) interleaves degree bookkeeping between
PBS batches; here the inputs are CLEAN blocks (degree < message_modulus), so
that bookkeeping is static: every op is a fixed chain of torus adds, block
shifts, bivariate packing and PBS batches with no host decision between
them (ref: integer/server_key/radix_parallel/add.rs:518-603 carry scan,
mul.rs:329-464 block products, comparator.rs:31-60 sign tree).  A chain
with no host read can be captured once into a CUDA graph and replayed
(`fused_dispatch.FusedIntegerOps`), the counterpart of the reference's one
`jax.jit` program per op.

Torus words are int64 tensors whose adds and products wrap as the
reference's uint64 ones (`ops/torus.py`).  Index and constant tensors are
built once per (values, device) and cached, so a call makes no host-to-
device copy after its first: a CUDA graph cannot capture one.  `mode`
names the blind rotation's schedule (None: the key kind's default), as
`shortint.ServerKey` does.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..core import (PreparedMultiBitBskNtt, keyswitch_then_multi_bit_pbs,
                    keyswitch_then_pbs)
from ..ops.fused_multibit import PreparedMultiBitBskCuda


@functools.cache
def _index(values: tuple, device: str) -> torch.Tensor:
    """An int64 index (or constant) tensor on `device`, made once."""
    return torch.tensor(values, dtype=torch.int64, device=device)


def _const(values, device: torch.device) -> torch.Tensor:
    """`values` (nested ints, u64 words as their int64 bit patterns) as a
    cached tensor on `device`."""
    arr = np.asarray(values)
    if arr.dtype == np.uint64:
        arr = arr.view(np.int64)
    return _index(tuple(arr.ravel().tolist()), str(device)).reshape(arr.shape)


def fused_ks_pbs(ksk, bsk, acc: torch.Tensor, cts: torch.Tensor, *,
                 mode: Optional[str] = None) -> torch.Tensor:
    """Batched keyswitch + PBS over any leading axes: [..., n+1].

    acc is one [G, N] accumulator or one per ciphertext with the same
    leading axes as cts ([..., G, N]).  A multi-bit prepared key takes the
    multi-bit PBS (tfhe_tpu/parallel/fused.py:35-42)."""
    lead = cts.shape[:-1]
    flat = cts.reshape(-1, cts.shape[-1])
    if acc.dim() > 3:
        acc = acc.reshape(-1, *acc.shape[-2:])
    if isinstance(bsk, (PreparedMultiBitBskCuda, PreparedMultiBitBskNtt)):
        out = keyswitch_then_multi_bit_pbs(ksk, bsk, acc, flat, mode)
    else:
        out = keyswitch_then_pbs(ksk, bsk, acc, flat, mode)
    return out.reshape(*lead, out.shape[-1])


def _shift_blocks_up(x: torch.Tensor, d: int) -> torch.Tensor:
    """[B, nb, sz]: new[:, i] = old[:, i-d]; trivial zeros (trivial LWE
    encryptions of 0) in at the least significant end."""
    if d == 0:
        return x
    B, nb, sz = x.shape
    zeros = torch.zeros((B, min(d, nb), sz), dtype=x.dtype, device=x.device)
    return torch.cat([zeros, x[:, :max(nb - d, 0)]], dim=1)


def fused_radix_add(ksk, bsk, state_acc, resolve_acc, carry_acc, msgext_acc,
                    a, b, *, message_modulus: int,
                    mode: Optional[str] = None):
    """Radix add of clean blocks a, b [B, nb, sz] with single-carry
    propagation -> clean sum blocks [B, nb, sz].

    IntegerServerKey.add_parallelized + propagate_single_carry as one
    chain: state PBS, log2(nb) bivariate resolve rounds, carry extract, add
    the carry-in, message extract."""
    return _propagate_single_carry(ksk, bsk, state_acc, resolve_acc,
                                   carry_acc, msgext_acc, a + b,
                                   message_modulus, mode)


def _propagate_single_carry(ksk, bsk, state_acc, resolve_acc, carry_acc,
                            msgext_acc, s, msg: int,
                            mode: Optional[str] = None):
    """Hillis-Steele single-carry propagation on [B, nb, sz] blocks
    (degrees <= 2*msg-2; block 0 may reach 2*msg-1)."""
    nb = s.shape[1]
    state = fused_ks_pbs(ksk, bsk, state_acc, s, mode=mode)
    d = 1
    while d < nb:
        prev = _shift_blocks_up(state, d)
        # bivariate packing (ref: bivariate_pbs.rs:167)
        state = fused_ks_pbs(ksk, bsk, resolve_acc, state * msg + prev,
                             mode=mode)
        d *= 2
    carries = fused_ks_pbs(ksk, bsk, carry_acc, state, mode=mode)
    return fused_ks_pbs(ksk, bsk, msgext_acc, s + _shift_blocks_up(carries, 1),
                        mode=mode)


def fused_radix_mul(ksk, bsk, lsb_acc, msb_acc, msgext_acc, carryext_acc,
                    state_acc, resolve_acc, carry_acc, a, b, *,
                    message_modulus: int, carry_modulus: int,
                    mode: Optional[str] = None):
    """Radix multiplication of clean blocks a, b [B, nb, sz] (msg >= 4).

    IntegerServerKey.mul_parallelized as one chain: the lsb and msb block
    products in two PBS batches, the carry-save column reduction with the
    host's schedule made static (every block entering a column has degree
    < msg, so the chunk sizes are known), then one single-carry
    propagation."""
    msg = message_modulus
    B, nb, sz = a.shape
    dev = a.device
    pairs_lsb = [(i, j) for j in range(nb) for i in range(nb - j)]
    pairs_msb = [(i, j) for j in range(nb) for i in range(nb - j)
                 if i + j + 1 < nb]

    def products(pairs, acc):
        ai = _const([i for i, _ in pairs], dev)
        bj = _const([j for _, j in pairs], dev)
        return fused_ks_pbs(ksk, bsk, acc, a[:, ai] * msg + b[:, bj],
                            mode=mode)  # [B, len(pairs), sz]

    prod_lsb = products(pairs_lsb, lsb_acc)
    columns = [[] for _ in range(nb)]
    for t, (i, j) in enumerate(pairs_lsb):
        columns[i + j].append(prod_lsb[:, t])
    if pairs_msb:
        prod_msb = products(pairs_msb, msb_acc)
        for t, (i, j) in enumerate(pairs_msb):
            columns[i + j + 1].append(prod_msb[:, t])

    chunk = max((msg * carry_modulus - 1) // (msg - 1), 2)
    while max(len(c) for c in columns) > 2:
        new_columns = [[] for _ in range(nb)]
        to_extract = []
        for p, col in enumerate(columns):
            for lo in range(0, len(col), chunk):
                part = col[lo:lo + chunk]
                if len(part) == 1:
                    new_columns[p].append(part[0])
                    continue
                acc_s = part[0]
                for other in part[1:]:
                    acc_s = acc_s + other
                to_extract.append((p, acc_s))
        if to_extract:
            stacked = torch.stack([t[1] for t in to_extract], dim=1)
            msgs = fused_ks_pbs(ksk, bsk, msgext_acc, stacked, mode=mode)
            carries = fused_ks_pbs(ksk, bsk, carryext_acc, stacked, mode=mode)
            for t, (p, _) in enumerate(to_extract):
                new_columns[p].append(msgs[:, t])
                if p + 1 < nb:
                    new_columns[p + 1].append(carries[:, t])
        columns = new_columns

    zero = torch.zeros((B, sz), dtype=a.dtype, device=dev)
    top = torch.stack([c[0] if c else zero for c in columns], dim=1)
    bot = torch.stack([c[1] if len(c) > 1 else zero for c in columns], dim=1)
    return _propagate_single_carry(ksk, bsk, state_acc, resolve_acc,
                                   carry_acc, msgext_acc, top + bot, msg,
                                   mode)


def _tree_reduce(ksk, bsk, acc, x, msg: int, mode: Optional[str] = None):
    """Pairwise reduction of axis -2: merged = LUT(hi * msg + lo) with the
    higher index as the bivariate lhs (IntegerServerKey._reduce_signs);
    an odd leftover passes through at the end."""
    while x.shape[-2] > 1:
        m = x.shape[-2]
        lo = x[..., 0:m - 1:2, :]
        hi = x[..., 1:m:2, :]
        merged = fused_ks_pbs(ksk, bsk, acc, hi * msg + lo, mode=mode)
        if m % 2 == 1:
            merged = torch.cat([merged, x[..., m - 1:m, :]], dim=-2)
        x = merged
    return x[..., 0, :]


def fused_strings_contains(ksk, bsk, sign_acc, resolve_acc, eq0_acc,
                           and_acc, or_acc, s, *,
                           pat_digits: Tuple[Tuple[int, ...], ...],
                           message_modulus: int, delta: int,
                           mode: Optional[str] = None):
    """contains(s, clear pattern) for a batch of strings in one chain.

    s: [B, n, nb, sz] clean char blocks, FINAL padding (chars past a
    string's length encrypt 0); pat_digits[j] holds the nb radix digits of
    pattern char j.  The host path's steps (ref: pattern.rs:106-115
    is_contained_in OR-fold; contains.rs:18-41): per-(offset, char) 3-state
    sign blocks, the block tree, the ==0 LUT, the AND tree over pattern
    chars, the OR tree over offsets.  Returns [B, sz] 0/1 blocks."""
    msg = message_modulus
    B, n, nb, sz = s.shape
    plen = len(pat_digits)
    dev = s.device
    if plen > 1:
        pad = torch.zeros((B, plen - 1, nb, sz), dtype=s.dtype, device=dev)
        sx = torch.cat([s, pad], dim=1)
    else:
        sx = s
    offsets = np.arange(n)[:, None] + np.arange(plen)[None, :]
    gather = sx[:, _const(offsets, dev)]           # [B, n, plen, nb, sz]
    # bivariate packing against the trivial pattern block: lhs * msg, and
    # the clear digit rides the body coefficient (a trivial LWE add)
    packed = gather * msg
    with np.errstate(over="ignore"):
        body = np.asarray(pat_digits, np.uint64) * np.uint64(delta)
    packed[..., -1] += _const(body, dev)[None, None]
    signs = fused_ks_pbs(ksk, bsk, sign_acc, packed, mode=mode)
    sign = _tree_reduce(ksk, bsk, resolve_acc, signs, msg, mode)
    eqs = fused_ks_pbs(ksk, bsk, eq0_acc, sign, mode=mode)  # [B, n, plen, sz]
    match = _tree_reduce(ksk, bsk, and_acc, eqs, msg, mode)  # [B, n, sz]
    return _tree_reduce(ksk, bsk, or_acc, match, msg, mode)  # [B, sz]


def _neg_correct(b, *, message_modulus: int, carry_modulus: int,
                 delta: int):
    """Per-block negation of CLEAN radix blocks with the borrow-absorbing
    correcting terms (ref: integer/server_key/radix/neg.rs).  For clean
    inputs the host's degree-driven schedule is static: z = msg for every
    block, a carry-in of 0 into block 0 and 1 above, so the body correction
    is msg*delta on block 0 and (msg-1)*delta above."""
    msg = message_modulus
    nb = b.shape[1]
    term = np.full(nb, msg, dtype=np.int64)
    term[1:] -= 1
    with np.errstate(over="ignore"):
        body = ((term % (2 * msg * carry_modulus)).astype(np.uint64)
                * np.uint64(delta))
    out = torch.zeros_like(b) - b
    out[..., -1] += _const(body, b.device)[None, :]
    return out


def fused_radix_neg(ksk, bsk, state_acc, resolve_acc, carry_acc, msgext_acc,
                    a, *, message_modulus: int, carry_modulus: int,
                    delta: int, mode: Optional[str] = None):
    """Radix negation of clean blocks in one chain (ref: radix_parallel/
    neg.rs and the single-carry propagation)."""
    s = _neg_correct(a, message_modulus=message_modulus,
                     carry_modulus=carry_modulus, delta=delta)
    return _propagate_single_carry(ksk, bsk, state_acc, resolve_acc,
                                   carry_acc, msgext_acc, s, message_modulus,
                                   mode)


def fused_radix_sub(ksk, bsk, state_acc, resolve_acc, carry_acc, msgext_acc,
                    a, b, *, message_modulus: int, carry_modulus: int,
                    delta: int, mode: Optional[str] = None):
    """a - b over clean radix blocks in one chain (ref: radix_parallel/
    sub.rs sub_parallelized)."""
    s = a + _neg_correct(b, message_modulus=message_modulus,
                         carry_modulus=carry_modulus, delta=delta)
    return _propagate_single_carry(ksk, bsk, state_acc, resolve_acc,
                                   carry_acc, msgext_acc, s, message_modulus,
                                   mode)


def fused_radix_eq(ksk, bsk, beq_acc, and_accs, a, b, *,
                   message_modulus: int, carry_modulus: int, delta: int,
                   negate: bool = False, mode: Optional[str] = None):
    """Equality of clean radix blocks through carry-space sum thresholds:
    one bivariate block-eq batch, then rounds that sum up to cap =
    max_noise_level fresh 0/1 blocks a chunk and test the sum against the
    chunk's width (ref: integer/server_key/comparator.rs eq loops).

    and_accs: {c: the (sum == c) LUT} for every chunk width on the static
    reduction path (`eq_chunk_widths`), and "not" for ne."""
    cap = (carry_modulus * message_modulus - 1) // (message_modulus - 1)
    bits = fused_ks_pbs(ksk, bsk, beq_acc, a * message_modulus + b,
                        mode=mode)  # [B, nb, sz]
    B, nb, sz = bits.shape
    while nb > 1:
        c = min(cap, nb)
        pad = (-nb) % c
        if pad:
            one = torch.zeros((B, pad, sz), dtype=bits.dtype,
                              device=bits.device)
            one[..., -1] = delta  # trivial encryptions of 1
            bits = torch.cat([bits, one], dim=1)
            nb += pad
        s = bits.reshape(B, nb // c, c, sz).sum(dim=2)
        bits = fused_ks_pbs(ksk, bsk, and_accs[c], s, mode=mode)
        nb //= c
    if negate:
        return fused_ks_pbs(ksk, bsk, and_accs["not"], bits[:, 0], mode=mode)
    return bits[:, 0]


def eq_chunk_widths(nb: int, cap: int):
    """The static chunk widths fused_radix_eq uses for nb blocks."""
    widths = set()
    while nb > 1:
        c = min(cap, nb)
        widths.add(c)
        nb = (nb + (-nb) % c) // c
    return widths


def fused_radix_cmp(ksk, bsk, sign_acc, resolve_acc, out_acc, a, b, *,
                    message_modulus: int, mode: Optional[str] = None):
    """Comparison of clean radix blocks: per-block 3-state signs, the
    MSB-first reduction tree, then the op's sign-to-boolean LUT (ref:
    integer/server_key/comparator.rs:31-60).  Returns [B, sz] 0/1
    blocks."""
    msg = message_modulus
    signs = fused_ks_pbs(ksk, bsk, sign_acc, a * msg + b, mode=mode)
    s = _tree_reduce(ksk, bsk, resolve_acc, signs, msg, mode)
    return fused_ks_pbs(ksk, bsk, out_acc, s, mode=mode)


def fused_radix_bitop(ksk, bsk, op_acc, a, b, *, message_modulus: int,
                      mode: Optional[str] = None):
    """Blockwise bivariate op (bitand/or/xor), one PBS batch (ref:
    radix_parallel/bitwise_op.rs)."""
    return fused_ks_pbs(ksk, bsk, op_acc, a * message_modulus + b, mode=mode)


def fused_radix_univariate(ksk, bsk, acc, a, *, mode: Optional[str] = None):
    """Blockwise univariate LUT (bitnot ...), one PBS batch."""
    return fused_ks_pbs(ksk, bsk, acc, a, mode=mode)


def fused_radix_select(ksk, bsk, then_acc, else_acc, msgext_acc, cond, a, b,
                       *, message_modulus: int, mode: Optional[str] = None):
    """if cond then a else b (ref: radix_parallel/cmux.rs:27).

    cond [B, sz] holds a value of the then/else accumulators' packing
    domain (a 0/1 boolean, or a 3-state comparison sign when the
    accumulators encode the selection); a, b [B, nb, sz].  Both branches'
    LUTs run in ONE PBS batch with an accumulator per ciphertext, then one
    message extract."""
    B, nb, sz = a.shape
    msg = message_modulus
    condr = cond[:, None, :].expand(a.shape)
    packed = torch.cat([condr * msg + a, condr * msg + b], dim=1)
    accs = torch.cat([then_acc[None].expand(nb, *then_acc.shape),
                      else_acc[None].expand(nb, *else_acc.shape)])
    accs = accs[None].expand(B, *accs.shape)           # [B, 2nb, G, N]
    out = fused_ks_pbs(ksk, bsk, accs, packed, mode=mode)  # [B, 2nb, sz]
    return fused_ks_pbs(ksk, bsk, msgext_acc, out[:, :nb] + out[:, nb:],
                        mode=mode)


def fused_radix_minmax(ksk, bsk, sign_acc, resolve_acc, then_acc, else_acc,
                       msgext_acc, a, b, *, message_modulus: int,
                       mode: Optional[str] = None):
    """max/min of clean radix blocks: the reduced comparison sign drives the
    select directly (the then/else accumulators encode s != 1 / s == 1 for
    max), without the sign-to-boolean batch (ref: radix_parallel/
    comparator.rs max_parallelized)."""
    msg = message_modulus
    signs = fused_ks_pbs(ksk, bsk, sign_acc, a * msg + b, mode=mode)
    s = _tree_reduce(ksk, bsk, resolve_acc, signs, msg, mode)
    return fused_radix_select(ksk, bsk, then_acc, else_acc, msgext_acc, s, a,
                              b, message_modulus=msg, mode=mode)
