"""The one traffic generator: a cell's requests, drawn from its seed.

A traffic file (benchmark/traffic/<name>.json) names the entry that
serves it and lists the request kinds of its mix; every kind is sent once
a round.  `order` is "shuffled_rounds" (each round in an order drawn from
the seed) or "fixed_rounds" (the mix's own order, so that every seed
sends the same sequence of request sizes and only the contents differ).
Each request gets a generator of its own, from which the entry draws its
operands, texts or patterns; the same seed gives the same requests.
"""

from __future__ import annotations

import itertools
from typing import Iterator, Tuple

import numpy as np

ORDERS = ("shuffled_rounds", "fixed_rounds")
STREAMS = {"pool": 1, "warmup": 2, "window": 3, "trace": 4}


def rng(seed: int, *path: int) -> np.random.Generator:
    """A numpy generator for one stream of a seed (any non-negative int)."""
    return np.random.default_rng([int(seed), *path])


def requests(traffic: dict, seed: int, stream: str,
             rounds: int = 0) -> Iterator[Tuple[dict, np.random.Generator]]:
    """(request kind, its generator), round after round; `rounds` > 0
    stops after that many."""
    mix = traffic["mix"]
    order = traffic.get("order", ORDERS[0])
    if order not in ORDERS:
        raise ValueError(f"unknown order {order!r}; expected one of "
                         f"{ORDERS}")
    sid = STREAMS[stream]
    round_rng = rng(seed, sid, 0)
    count = itertools.count()
    for r in (range(rounds) if rounds else itertools.count()):
        idx = (round_rng.permutation(len(mix)) if order == "shuffled_rounds"
               else range(len(mix)))
        for i in idx:
            yield mix[int(i)], rng(seed, sid, 1, next(count))
