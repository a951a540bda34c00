"""Dark market: encrypted volume matching of buy/sell order books.

Port of `tfhe_tpu/examples/dark_market.py` (ref: tfhe/examples/dark_market/
{plain.rs, improved_plain.rs, improved_parallel_fhe.rs}): orders are
encrypted quantities; the exchange fills them against the opposite side's
total volume without learning any amount.  Every step is a radix op of the
port's `IntegerServerKey`, on the key's device.

Algorithm (the reference's "improved" prefix-sum formulation):
    filled_i = clamp(total_other - prefix_sum_{i-1}, 0, order_i)
which needs one prefix-sum pass and an independent (hence batchable)
min/select per order instead of a sequential fill loop.
"""

from __future__ import annotations

from typing import List, Tuple

from ..integer import IntegerServerKey, RadixCiphertext, RadixClientKey


def volume_match_plain(sell_orders: List[int],
                       buy_orders: List[int]) -> Tuple[List[int], List[int]]:
    """Clear reference implementation (ref: dark_market/plain.rs:1-24)."""
    total_sell, total_buy = sum(sell_orders), sum(buy_orders)
    total = min(total_sell, total_buy)

    def fill(orders):
        left = total
        out = []
        for o in orders:
            f = min(left, o)
            out.append(f)
            left -= f
        return out

    return fill(sell_orders), fill(buy_orders)


def _prefix_sums(sks: IntegerServerKey,
                 orders: List[RadixCiphertext]) -> List[RadixCiphertext]:
    """Running sums (ref: improved_plain.rs compute_prefix_sum)."""
    sums = []
    acc = None
    for o in orders:
        acc = o if acc is None else sks.add_parallelized(acc, o)
        sums.append(acc)
    return sums


def _fill_orders(sks: IntegerServerKey, total_other: RadixCiphertext,
                 orders: List[RadixCiphertext],
                 prefix: List[RadixCiphertext]) -> List[RadixCiphertext]:
    """filled_i = clamp(total_other - prefix_{i-1}, 0, order_i)
    (ref: improved_plain.rs fill_orders) — each order is independent, so
    these iterations are batchable lanes."""
    zero = sks.create_trivial_radix(0, orders[0].num_blocks)
    out = []
    for i, order in enumerate(orders):
        prev = zero if i == 0 else prefix[i - 1]
        ge = sks.ge_parallelized(total_other, prev)
        diff = sks.sub_parallelized(total_other, prev)
        avail = sks.if_then_else_parallelized(ge, diff, zero)
        out.append(sks.min_parallelized(avail, order))
    return out


def volume_match_fhe(sks: IntegerServerKey,
                     sell_orders: List[RadixCiphertext],
                     buy_orders: List[RadixCiphertext]):
    """(ref: dark_market/improved_parallel_fhe.rs volume_match)"""
    ps_sell = _prefix_sums(sks, sell_orders)
    ps_buy = _prefix_sums(sks, buy_orders)
    total_sell = ps_sell[-1]
    total_buy = ps_buy[-1]
    filled_sells = _fill_orders(sks, total_buy, sell_orders, ps_sell)
    filled_buys = _fill_orders(sks, total_sell, buy_orders, ps_buy)
    return filled_sells, filled_buys


def run_example(cks: RadixClientKey, sks: IntegerServerKey,
                sell_orders: List[int], buy_orders: List[int]):
    """Encrypt, match, decrypt — returns (filled_sells, filled_buys)."""
    enc_sells = [cks.encrypt(v) for v in sell_orders]
    enc_buys = [cks.encrypt(v) for v in buy_orders]
    fs, fb = volume_match_fhe(sks, enc_sells, enc_buys)
    return ([cks.decrypt(c) for c in fs], [cks.decrypt(c) for c in fb])
