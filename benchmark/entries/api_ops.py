"""FheUint ops through the high-level API (`tfhe_tpu_torch.api`): one
client, one op a request, operands from a pool encrypted at set-up.

The keys are the API's (`api.ClientKey` on the benchmark's secret key,
`api.ServerKey(fused=...)`, `api.set_server_key`); with `fused` true every
(op, shape) is one CUDA graph, captured at its first call.  Traffic keys:
`fused`, `pool` {"integers", "booleans"}, and a mix of {"op": ...} from
OPS.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import program
from .. import traffic as traffic_gen
from ..reference import clear, lwe

OPS = {
    "add": lambda a, b, c: a + b,
    "sub": lambda a, b, c: a - b,
    "mul": lambda a, b, c: a * b,
    "bitxor": lambda a, b, c: a ^ b,
    "max": lambda a, b, c: a.max(b),
    "eq": lambda a, b, c: a.eq(b),
    "lt": lambda a, b, c: a.lt(b),
    "if_then_else": lambda a, b, c: c.if_then_else(a, b),
}


class Entry:
    def __init__(self, cfg, traffic, seed, device, enc, small, glwe):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.enc = device, enc
        self.small, self.glwe = small, glwe
        self.bits = int(cfg["integer_bits"])
        msg = enc.message_modulus
        self.num_blocks = -(-self.bits // (msg.bit_length() - 1))
        for item in traffic["mix"]:
            if item["op"] not in OPS:
                raise KeyError(f"unknown op {item['op']!r}")
        pool = traffic["pool"]
        rng = traffic_gen.rng(seed, traffic_gen.STREAMS["pool"])
        self.values = [int(v) for v in rng.integers(
            0, 1 << self.bits, size=int(pool["integers"]), dtype=np.uint64)]
        self.bools = [bool(v) for v in rng.integers(
            0, 2, size=int(pool["booleans"]))]

    # -- program side ------------------------------------------------------

    def keygen(self):
        from tfhe_tpu_torch import api
        from tfhe_tpu_torch.integer import RadixClientKey

        self.params = program.parameters(self.cfg)
        cks = program.client_key(self.params, self.small, self.glwe,
                                 self.seed, self.device)
        config = api.ConfigBuilder.default().use_custom_parameters(
            self.params).build()
        self.client = api.ClientKey(config, _radix=RadixClientKey(
            self.params, 1, _key=cks))
        self.server = api.ServerKey(self.client,
                                    fused=bool(self.traffic["fused"]))
        api.set_server_key(self.server)
        self.uint = getattr(api, f"FheUint{self.bits}")
        self.fbool = api.FheBool

    def prepare(self):
        """Encrypt the pool with the benchmark's key (plain reference)."""
        from tfhe_tpu_torch.integer import BooleanBlock, RadixCiphertext

        msg = self.enc.message_modulus
        g = lwe.generator(self.seed, 2, self.device)
        big = self.glwe.reshape(-1)
        digs = torch.tensor([clear.digits(v, self.num_blocks, msg)
                             for v in self.values])
        rows = lwe.encrypt(self.enc, big, digs, g)
        self.ints = [self.uint(RadixCiphertext(program.blocks(
            r, msg - 1, self.params))) for r in rows]
        brows = lwe.encrypt(self.enc, big, torch.tensor(
            [[int(b)] for b in self.bools]), g)
        self.conds = [self.fbool(BooleanBlock(program.blocks(
            r, 1, self.params))) for r in brows]

    def submit(self, req) -> torch.Tensor:
        a, b = self.ints[req["a"]], self.ints[req["b"]]
        out = OPS[req["op"]](a, b, self.conds[req["c"]]).inner
        blocks = out.blocks if hasattr(out, "blocks") else out.block
        return blocks.data

    def close(self):
        from tfhe_tpu_torch import api

        api.set_server_key(None)
        self.ints = self.conds = self.server = self.client = None

    # -- benchmark side ----------------------------------------------------

    def make(self, kind: dict, rng) -> dict:
        return {"op": kind["op"],
                "a": int(rng.integers(len(self.values))),
                "b": int(rng.integers(len(self.values))),
                "c": int(rng.integers(len(self.bools)))}

    def kind(self, req) -> str:
        return req["op"]

    def ops(self, req) -> int:
        return 1

    def answer(self, req, bits: int = 0) -> list:
        """Decoded values of the output blocks; `bits` below the
        configuration's gives the control's."""
        return clear.integer_answer(
            req["op"], self.values[req["a"]], self.values[req["b"]],
            self.bools[req["c"]], self.num_blocks, self.enc.message_modulus,
            bits or self.bits)
