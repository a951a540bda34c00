"""The clean-block radix schedules: whole radix operations as one static
sequence of keyswitch + PBS batches over [B, nb, lwe_size] block tensors,
their LUTs and the table of ops that binds the two.

Port of the non-mesh half of `tfhe_tpu/parallel/fused.py` (`:24-406`) and
of the wave schedules of `tfhe_tpu/integer/batched.py`.  The host path
(`integer/server_key.py`) interleaves degree bookkeeping between PBS
batches; here the inputs are CLEAN blocks (degree < message_modulus), so
that bookkeeping is static: every op is a fixed chain of torus adds, block
shifts, bivariate packing and PBS batches with no host decision between
them (ref: integer/server_key/radix_parallel/add.rs:518-603 carry scan,
mul.rs:329-464 block products, comparator.rs:31-60 sign tree).

One schedule, two fronts (`_radix_op` binds either):
- `fused_dispatch.FusedIntegerOps`, one radix integer an op, captures a
  chain with no host read once into a CUDA graph and replays it (the
  counterpart of the reference's one `jax.jit` program per op); its
  batches cross `keyswitch_then_pbs`;
- `batched.BatchedRadixOps`, B integers a wave, runs the same chains
  eagerly in either carry schedule; its batches cross the shortint key's
  `_pbs_device`.
A chain takes `pbs(rows, acc) -> rows`, the function that runs one
keyswitch + PBS batch over [rows, n+1] words, so each front keeps its own
call site.

Torus words are int64 tensors whose adds and products wrap as the
reference's uint64 ones (`ops/torus.py`).  Index and constant tensors are
built once per (values, device) and cached, so a call makes no host-to-
device copy after its first: a CUDA graph cannot capture one.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from .. import core
from ..ops.fused_multibit import PreparedMultiBitBskCuda

MULTI_BIT_KEYS = (PreparedMultiBitBskCuda, core.PreparedMultiBitBskNtt)


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


# -- the LUT table ---------------------------------------------------------
# Every LUT of the clean-block schedules, written once: f(msg, v) for a
# univariate one, f(msg, hi, lo) for a bivariate one (its input hi*msg+lo).

_UNIVARIATE = {
    # carry propagation (ref: radix_parallel/add.rs:518-603): the 3-state
    # block (2 generates, 1 propagates), the resolved state's carry, the
    # ripple chain's carry, and the extracts
    "state": lambda m, v: 2 if v >= m else (1 if v == m - 1 else 0),
    "carry": lambda m, v: int(v == 2),
    "rcarry": lambda m, v: int(v >= m),
    "msgext": lambda m, v: v % m,
    "carryext": lambda m, v: v // m,
    "not": lambda m, v: int(v == 0),
    # sign to boolean (ref: integer/server_key/comparator.rs:31-60)
    "lt": lambda m, s: int(s == 1),
    "le": lambda m, s: int(s != 2),
    "gt": lambda m, s: int(s == 2),
    "ge": lambda m, s: int(s != 1),
    # (ref: radix_parallel/bitwise_op.rs)
    "bnot": lambda m, x: (m - 1) - (x % m),
}

_BIVARIATE = {
    "resolve": lambda m, cur, prev: min(prev if cur == 1 else cur, 2),
    "sign": lambda m, x, y: 0 if x == y else (1 if x < y else 2),
    "sresolve": lambda m, high, low: min(low if high == 0 else high, 2),
    "beq_01": lambda m, x, y: int(x == y),
    "band": lambda m, x, y: x & y,
    "bor": lambda m, x, y: x | y,
    "bxor": lambda m, x, y: x ^ y,
    # cmux (ref: radix_parallel/cmux.rs:27), and the sign-driven cmux of
    # max/min (s == 1: lhs < rhs)
    "cthen": lambda m, c, x: x if c else 0,
    "celse": lambda m, c, x: 0 if c else x,
    "maxthen": lambda m, s, x: x if s != 1 else 0,
    "maxelse": lambda m, s, x: x if s == 1 else 0,
    "minthen": lambda m, s, x: x if s != 2 else 0,
    "minelse": lambda m, s, x: x if s == 2 else 0,
    # multiplication (ref: radix_parallel/mul.rs:329-464)
    "mlsb": lambda m, x, y: (x * y) % m,
    "mmsb": lambda m, x, y: (x * y) // m,
    # strings' contains (ref: tfhe_tpu/parallel/fused.py:556-568)
    "and": lambda m, x, y: int(bool(x) and bool(y)),
    "or": lambda m, x, y: int(bool(x) or bool(y)),
}

_CARRY_LUTS = ("state", "resolve", "carry", "msgext")
_MUL_LUTS = ("mlsb", "mmsb", "msgext", "carryext")
_CONTAINS_LUTS = ("sign", "sresolve", "not", "and", "or")


def _lut(sks, name, packed: bool = False):
    """The LookupTable `name` on the shortint key `sks`, through its
    table-keyed cache (`generate_lookup_table`).  ("and_sum", c) tests a
    sum of c 0/1 blocks against c.

    A bivariate LUT reads v = hi*msg + lo: in the shortint key's bivariate
    form f((v // msg) % msg, v % msg) (the chains' reference,
    tfhe_tpu/integer/fused_dispatch.py), or, `packed`, f(v // msg,
    v % msg) (the batched waves' reference, tfhe_tpu/integer/batched.py:
    66-70).  Clean inputs never reach v >= msg**2, where the two differ
    (carry > msg), but the polynomial holds the whole domain, so each front
    keeps its reference's form to keep its words."""
    m = sks.message_modulus
    if isinstance(name, tuple):
        c = name[1]
        return sks.generate_lookup_table(lambda v: int(v == c))
    if name in _UNIVARIATE:
        f = _UNIVARIATE[name]
        return sks.generate_lookup_table(lambda v: f(m, v))
    f = _BIVARIATE[name]
    if packed:
        return sks.generate_lookup_table(lambda v: f(m, v // m, v % m))
    return sks.generate_lookup_table_bivariate(lambda x, y: f(m, x, y)).acc


def _accs(sks, names, packed: bool = False, device=None) -> list:
    """The accumulators [G, N] of the LUTs `names` (on `device` if given)."""
    out = [_lut(sks, n, packed).acc for n in names]
    return out if device is None else [a.to(device) for a in out]


# -- the batch function ----------------------------------------------------


def keyswitch_then_pbs(ksk, bsk, lut: torch.Tensor, ct_big: torch.Tensor,
                       mode: Optional[str] = None) -> torch.Tensor:
    """One keyswitch + PBS batch [B, n+1] of the chains, the graph front's
    one call site: a multi-bit prepared key takes the multi-bit PBS, any
    other the classic one (tfhe_tpu/parallel/fused.py:35-42)."""
    fn = (core.keyswitch_then_multi_bit_pbs
          if isinstance(bsk, MULTI_BIT_KEYS) else core.keyswitch_then_pbs)
    return fn(ksk, bsk, lut, ct_big, mode)


def _pbs_on(ksk, bsk, mode: Optional[str] = None):
    """The chains' batch function on a key pair: `keyswitch_then_pbs`,
    looked up at every batch so that a wrapper installed on this module
    sees each one."""
    def pbs(rows: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
        return keyswitch_then_pbs(ksk, bsk, acc, rows, mode)
    return pbs


def _batch(pbs, acc: torch.Tensor, cts: torch.Tensor) -> torch.Tensor:
    """One batch of pbs over any leading axes: [..., n+1].

    acc is one [G, N] accumulator or one per ciphertext with the same
    leading axes as cts ([..., G, N])."""
    lead = cts.shape[:-1]
    if acc.dim() > 3:
        acc = acc.reshape(-1, *acc.shape[-2:])
    out = pbs(cts.reshape(-1, cts.shape[-1]), acc)
    return out.reshape(*lead, out.shape[-1])


def fused_ks_pbs(ksk, bsk, acc: torch.Tensor, cts: torch.Tensor, *,
                 mode: Optional[str] = None) -> torch.Tensor:
    """Batched keyswitch + PBS over any leading axes: [..., n+1] (`_batch`
    through `keyswitch_then_pbs`)."""
    return _batch(_pbs_on(ksk, bsk, mode), acc, cts)


def _shift_blocks_up(x: torch.Tensor, d: int) -> torch.Tensor:
    """[B, nb, sz]: new[:, i] = old[:, i-d]; trivial zeros (trivial LWE
    encryptions of 0) in at the least significant end."""
    if d == 0:
        return x
    B, nb, sz = x.shape
    zeros = torch.zeros((B, min(d, nb), sz), dtype=x.dtype, device=x.device)
    return torch.cat([zeros, x[:, :max(nb - d, 0)]], dim=1)


# -- carry propagation -----------------------------------------------------
# Both schedules take [B, nb, sz] sums in one invariant: every block that
# takes a carry-in holds at most 2*msg-2 (a sum of two clean blocks); only
# the carry-free least significant block may reach 2*msg-1 (a negation's
# correction).


def _propagate_single_carry(pbs, state_acc, resolve_acc, carry_acc,
                            msgext_acc, s, msg: int):
    """Hillis-Steele single-carry propagation: the state batch, log2(nb)
    bivariate resolve rounds, the carry extract, the carry-in added, the
    message extract (3 + log2(nb) batches, each B*nb wide)."""
    nb = s.shape[1]
    state = _batch(pbs, state_acc, s)
    d = 1
    while d < nb:
        prev = _shift_blocks_up(state, d)
        # bivariate packing (ref: bivariate_pbs.rs:167)
        state = _batch(pbs, resolve_acc, state * msg + prev)
        d *= 2
    carries = _batch(pbs, carry_acc, state)
    return _batch(pbs, msgext_acc, s + _shift_blocks_up(carries, 1))


def _propagate_ripple(pbs, rcarry_acc, msgext_acc, s):
    """Serial carry chain: carry_i = LUT(s_i + carry_{i-1}) >= msg, one
    B-wide batch a block, then one B*nb-wide message extract (about 2 PBS
    a block in place of 3 + log2(nb)).

    With the 0/1 carry the LUT's argument stays below 2*msg <=
    msg*carry_mod (a carry-in on a block at 2*msg-1 would reach 2*msg and
    be misread); the noise level is that of 3 fresh blocks, within
    max_noise_level (2_2: 5)."""
    nb = s.shape[1]
    if nb == 1:
        return _batch(pbs, msgext_acc, s)
    carry = _batch(pbs, rcarry_acc, s[:, 0])
    carries = [carry]
    for i in range(1, nb - 1):
        carry = _batch(pbs, rcarry_acc, s[:, i] + carry)
        carries.append(carry)
    shifted = torch.cat([torch.zeros_like(s[:, :1]),
                         torch.stack(carries, dim=1)], dim=1)
    return _batch(pbs, msgext_acc, s + shifted)


# -- the chains ------------------------------------------------------------


def fused_radix_add(pbs, state_acc, resolve_acc, carry_acc, msgext_acc, a,
                    b, *, message_modulus: int):
    """Radix add of clean blocks a, b [B, nb, sz] with single-carry
    propagation -> clean sum blocks [B, nb, sz]
    (IntegerServerKey.add_parallelized + propagate_single_carry)."""
    return _propagate_single_carry(pbs, state_acc, resolve_acc, carry_acc,
                                   msgext_acc, a + b, message_modulus)


def _mul_columns(pbs, lsb_acc, msb_acc, msgext_acc, carryext_acc, a, b, *,
                 message_modulus: int, carry_modulus: int):
    """The block products of clean a, b [B, nb, sz] (msg >= 4) reduced to
    two clean blocks a column, summed: the lsb and msb products in two
    PBS batches, then the carry-save column reduction with the host's
    schedule made static (every block entering a column has degree < msg,
    so the chunk sizes are known; ref: mul.rs:329-464 and the add.rs:789
    sum trees).  The result awaits a carry propagation."""
    msg = message_modulus
    B, nb, sz = a.shape
    dev = a.device
    pairs_lsb = [(i, j) for j in range(nb) for i in range(nb - j)]
    pairs_msb = [(i, j) for j in range(nb) for i in range(nb - j)
                 if i + j + 1 < nb]

    def products(pairs, acc):
        ai = _const([i for i, _ in pairs], dev)
        bj = _const([j for _, j in pairs], dev)
        return _batch(pbs, acc, a[:, ai] * msg + b[:, bj])

    prod_lsb = products(pairs_lsb, lsb_acc)  # [B, len(pairs), sz]
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
            msgs = _batch(pbs, msgext_acc, stacked)
            carries = _batch(pbs, carryext_acc, stacked)
            for t, (p, _) in enumerate(to_extract):
                new_columns[p].append(msgs[:, t])
                if p + 1 < nb:
                    new_columns[p + 1].append(carries[:, t])
        columns = new_columns

    zero = torch.zeros((B, sz), dtype=a.dtype, device=dev)
    top = torch.stack([c[0] if c else zero for c in columns], dim=1)
    bot = torch.stack([c[1] if len(c) > 1 else zero for c in columns], dim=1)
    return top + bot


def fused_radix_mul(pbs, lsb_acc, msb_acc, msgext_acc, carryext_acc,
                    state_acc, resolve_acc, carry_acc, a, b, *,
                    message_modulus: int, carry_modulus: int):
    """Radix multiplication of clean blocks a, b [B, nb, sz] (msg >= 4)
    (IntegerServerKey.mul_parallelized): the column reduction, then one
    single-carry propagation."""
    s = _mul_columns(pbs, lsb_acc, msb_acc, msgext_acc, carryext_acc, a, b,
                     message_modulus=message_modulus,
                     carry_modulus=carry_modulus)
    return _propagate_single_carry(pbs, state_acc, resolve_acc, carry_acc,
                                   msgext_acc, s, message_modulus)


def _tree_reduce(pbs, acc, x, msg: int):
    """Pairwise reduction of axis -2: merged = LUT(hi * msg + lo) with the
    higher index as the bivariate lhs (IntegerServerKey._reduce_signs);
    an odd leftover passes through at the end."""
    while x.shape[-2] > 1:
        m = x.shape[-2]
        lo = x[..., 0:m - 1:2, :]
        hi = x[..., 1:m:2, :]
        merged = _batch(pbs, acc, hi * msg + lo)
        if m % 2 == 1:
            merged = torch.cat([merged, x[..., m - 1:m, :]], dim=-2)
        x = merged
    return x[..., 0, :]


def fused_strings_contains(pbs, sign_acc, resolve_acc, eq0_acc, and_acc,
                           or_acc, s, *,
                           pat_digits: Tuple[Tuple[int, ...], ...],
                           message_modulus: int, delta: int):
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
    signs = _batch(pbs, sign_acc, packed)
    sign = _tree_reduce(pbs, resolve_acc, signs, msg)
    eqs = _batch(pbs, eq0_acc, sign)                    # [B, n, plen, sz]
    match = _tree_reduce(pbs, and_acc, eqs, msg)        # [B, n, sz]
    return _tree_reduce(pbs, or_acc, match, msg)        # [B, sz]


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


def fused_radix_neg(pbs, state_acc, resolve_acc, carry_acc, msgext_acc, a,
                    *, message_modulus: int, carry_modulus: int,
                    delta: int):
    """Radix negation of clean blocks in one chain (ref: radix_parallel/
    neg.rs and the single-carry propagation)."""
    s = _neg_correct(a, message_modulus=message_modulus,
                     carry_modulus=carry_modulus, delta=delta)
    return _propagate_single_carry(pbs, state_acc, resolve_acc, carry_acc,
                                   msgext_acc, s, message_modulus)


def fused_radix_sub(pbs, state_acc, resolve_acc, carry_acc, msgext_acc, a,
                    b, *, message_modulus: int, carry_modulus: int,
                    delta: int):
    """a - b over clean radix blocks in one chain (ref: radix_parallel/
    sub.rs sub_parallelized)."""
    s = a + _neg_correct(b, message_modulus=message_modulus,
                         carry_modulus=carry_modulus, delta=delta)
    return _propagate_single_carry(pbs, state_acc, resolve_acc, carry_acc,
                                   msgext_acc, s, message_modulus)


def fused_radix_eq(pbs, beq_acc, and_accs, a, b, *, message_modulus: int,
                   cap: int, delta: int, negate: bool = False):
    """Equality of clean radix blocks through carry-space sum thresholds:
    one bivariate block-eq batch, then rounds that sum up to cap (the
    key's max_noise_level) fresh 0/1 blocks a chunk and test the sum
    against the chunk's width (ref: integer/server_key/comparator.rs eq
    loops).

    and_accs: {c: the (sum == c) LUT} for every chunk width on the static
    reduction path (`eq_chunk_widths`), and "not" for ne."""
    bits = _batch(pbs, beq_acc, a * message_modulus + b)  # [B, nb, sz]
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
        bits = _batch(pbs, and_accs[c], s)
        nb //= c
    if negate:
        return _batch(pbs, and_accs["not"], bits[:, 0])
    return bits[:, 0]


def eq_chunk_widths(nb: int, cap: int):
    """The static chunk widths fused_radix_eq uses for nb blocks."""
    widths = set()
    while nb > 1:
        c = min(cap, nb)
        widths.add(c)
        nb = (nb + (-nb) % c) // c
    return widths


def fused_radix_cmp(pbs, sign_acc, resolve_acc, out_acc, a, b, *,
                    message_modulus: int):
    """Comparison of clean radix blocks: per-block 3-state signs, the
    MSB-first reduction tree, then the op's sign-to-boolean LUT (ref:
    integer/server_key/comparator.rs:31-60).  Returns [B, sz] 0/1
    blocks."""
    msg = message_modulus
    signs = _batch(pbs, sign_acc, a * msg + b)
    s = _tree_reduce(pbs, resolve_acc, signs, msg)
    return _batch(pbs, out_acc, s)


def fused_radix_bitop(pbs, op_acc, a, b, *, message_modulus: int):
    """Blockwise bivariate op (bitand/or/xor), one PBS batch (ref:
    radix_parallel/bitwise_op.rs)."""
    return _batch(pbs, op_acc, a * message_modulus + b)


def fused_radix_univariate(pbs, acc, a):
    """Blockwise univariate LUT (bitnot ...), one PBS batch."""
    return _batch(pbs, acc, a)


def fused_radix_select(pbs, then_acc, else_acc, msgext_acc, cond, a, b, *,
                       message_modulus: int):
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
    out = _batch(pbs, accs, packed)                    # [B, 2nb, sz]
    return _batch(pbs, msgext_acc, out[:, :nb] + out[:, nb:])


def fused_radix_minmax(pbs, sign_acc, resolve_acc, then_acc, else_acc,
                       msgext_acc, a, b, *, message_modulus: int):
    """max/min of clean radix blocks: the reduced comparison sign drives the
    select directly (the then/else accumulators encode s != 1 / s == 1 for
    max), without the sign-to-boolean batch (ref: radix_parallel/
    comparator.rs max_parallelized)."""
    msg = message_modulus
    signs = _batch(pbs, sign_acc, a * msg + b)
    s = _tree_reduce(pbs, resolve_acc, signs, msg)
    return fused_radix_select(pbs, then_acc, else_acc, msgext_acc, s, a, b,
                              message_modulus=msg)


# -- the op table ----------------------------------------------------------

_CARRY_OPS = ("add", "sub", "neg", "mul")


def _radix_op(sks, op: str, nb: int, pbs, *, packed: bool = False,
              carry: str = "scan", device=None):
    """`op`'s chain over clean nb-block inputs, bound to the batch function
    `pbs(rows, acc)` and to its LUTs on the shortint key `sks` (built now,
    on `device` if given): fn(*inputs) -> output.

    Ops: add sub neg mul (their carry propagation in the schedule `carry`,
    "scan" or "ripple"), eq ne lt le gt ge ([B, sz] 0/1 blocks), band bor
    bxor bnot, select (cond [B, sz] first), max min.  `packed` picks the
    bivariate LUTs' form (`_lut`)."""
    msg = sks.message_modulus
    kw = dict(message_modulus=msg)
    neg_kw = dict(kw, carry_modulus=sks.carry_modulus, delta=sks.delta)

    def get(*names):
        return _accs(sks, names, packed, device)

    if op in _CARRY_OPS and carry == "ripple":
        propagate = functools.partial(_propagate_ripple, pbs,
                                      *get("rcarry", "msgext"))
        if op == "mul":
            columns = functools.partial(
                _mul_columns, pbs, *get(*_MUL_LUTS),
                carry_modulus=sks.carry_modulus, **kw)
            return lambda a, b: propagate(columns(a, b))
        neg = functools.partial(_neg_correct, **neg_kw)
        return {"add": lambda a, b: propagate(a + b),
                "sub": lambda a, b: propagate(a + neg(b)),
                "neg": lambda a: propagate(neg(a))}[op]
    if op in ("add", "sub", "neg"):
        chain = {"add": functools.partial(fused_radix_add, **kw),
                 "sub": functools.partial(fused_radix_sub, **neg_kw),
                 "neg": functools.partial(fused_radix_neg, **neg_kw)}[op]
        return functools.partial(chain, pbs, *get(*_CARRY_LUTS))
    if op == "mul":
        return functools.partial(
            fused_radix_mul, pbs, *get(*_MUL_LUTS, "state", "resolve",
                                       "carry"),
            carry_modulus=sks.carry_modulus, **kw)
    if op in ("eq", "ne"):
        cap = sks.max_noise_level
        widths = sorted(eq_chunk_widths(nb, cap))
        and_accs = dict(zip(widths, get(*(("and_sum", c) for c in widths))))
        and_accs["not"], = get("not")
        return functools.partial(fused_radix_eq, pbs, *get("beq_01"),
                                 and_accs, cap=cap, delta=sks.delta,
                                 negate=op == "ne", **kw)
    if op in ("lt", "le", "gt", "ge"):
        return functools.partial(fused_radix_cmp, pbs,
                                 *get("sign", "sresolve", op), **kw)
    if op in ("band", "bor", "bxor"):
        return functools.partial(fused_radix_bitop, pbs, *get(op), **kw)
    if op == "bnot":
        return functools.partial(fused_radix_univariate, pbs, *get(op))
    if op == "select":
        return functools.partial(fused_radix_select, pbs,
                                 *get("cthen", "celse", "msgext"), **kw)
    if op in ("max", "min"):
        return functools.partial(
            fused_radix_minmax, pbs,
            *get("sign", "sresolve", op + "then", op + "else", "msgext"),
            **kw)
    raise KeyError(op)
