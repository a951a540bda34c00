"""Batched radix integers (`tfhe_tpu_torch.integer.batched.
BatchedRadixOps`): one request applies one op to `batch` independent
pairs, every PBS round one wave over all of them, carries resolved by the
parallel-prefix scan (`mode="scan"`).

Traffic keys: `batch`, `pool` {"integers"}, and a mix of {"op": ...} from
OPS.  Operands are pool
integers encrypted at set-up, gathered on the card for each request.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import program
from .. import traffic as traffic_gen
from ..reference import clear, lwe

OPS = ("add", "sub", "eq", "lt")


class Entry:
    def __init__(self, cfg, traffic, seed, device, enc, small, glwe):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.enc = device, enc
        self.small, self.glwe = small, glwe
        self.bits = int(cfg["integer_bits"])
        self.num_blocks = -(-self.bits // (enc.message_modulus.bit_length()
                                           - 1))
        self.batch = int(traffic["batch"])
        for item in traffic["mix"]:
            if item["op"] not in OPS:
                raise KeyError(f"unknown op {item['op']!r}")
        rng = traffic_gen.rng(seed, traffic_gen.STREAMS["pool"])
        self.values = [int(v) for v in rng.integers(
            0, 1 << self.bits, size=int(traffic["pool"]["integers"]),
            dtype=np.uint64)]

    def keygen(self):
        from tfhe_tpu_torch.integer.batched import BatchedRadixOps
        from tfhe_tpu_torch.shortint import ServerKey

        self.params = program.parameters(self.cfg)
        cks = program.client_key(self.params, self.small, self.glwe,
                                 self.seed, self.device)
        self.server = ServerKey(cks)
        self.radix = BatchedRadixOps(self.server, "scan")

    def prepare(self):
        digs = torch.tensor([clear.digits(v, self.num_blocks,
                                          self.enc.message_modulus)
                             for v in self.values])
        self.pool = lwe.encrypt(self.enc, self.glwe.reshape(-1), digs,
                                lwe.generator(self.seed, 2, self.device))

    def submit(self, req) -> torch.Tensor:
        out = getattr(self.radix, req["op"])(self.pool[req["a_index"]],
                                             self.pool[req["b_index"]])
        return out.reshape(-1, out.shape[-1])

    def close(self):
        self.pool = self.radix = self.server = None

    def make(self, kind: dict, rng) -> dict:
        n = len(self.values)
        a = rng.integers(n, size=self.batch)
        b = rng.integers(n, size=self.batch)
        return {"op": kind["op"], "a": a.tolist(), "b": b.tolist(),
                "a_index": torch.as_tensor(a, device=self.device),
                "b_index": torch.as_tensor(b, device=self.device)}

    def kind(self, req) -> str:
        return req["op"]

    def ops(self, req) -> int:
        return self.batch

    def answer(self, req, bits: int = 0) -> list:
        msg = self.enc.message_modulus
        return [v for i, j in zip(req["a"], req["b"])
                for v in clear.integer_answer(
                    req["op"], self.values[i], self.values[j], False,
                    self.num_blocks, msg, bits or self.bits)]
