"""Batched encrypted-string search (`tfhe_tpu_torch.strings.batched.
BatchedStringOps`): one request searches `batch` encrypted texts for one
clear pattern, `contains` or `find`.

Texts are printable ASCII (codes 32-126) of `text_len` [lo, hi] chars,
FINAL-padded with zero chars to the configuration's `max_len`, `chars_per`
radix blocks a char, least significant first; a pool of them is encrypted
at set-up and each request gathers a page of `batch` distinct texts.  A
share `pattern_from_text` of the patterns is cut from a text of the page,
so matches occur; the rest are random printable chars.  Traffic keys:
`batch`, `text_len`, `pattern_from_text`, `pool` {"texts"}, and a mix of
{"op": "contains" | "find", "pattern_len": n}.
"""

from __future__ import annotations

import torch

from .. import program
from .. import traffic as traffic_gen
from ..reference import clear, lwe

OPS = ("contains", "find")
PRINTABLE = (32, 127)


class Entry:
    def __init__(self, cfg, traffic, seed, device, enc, small, glwe):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.enc = device, enc
        self.small, self.glwe = small, glwe
        self.max_len = int(cfg["max_len"])
        self.blocks_per_char = int(cfg["blocks_per_char"])
        self.char_bits = int(cfg["char_bits"])
        self.batch = int(traffic["batch"])
        for item in traffic["mix"]:
            if item["op"] not in OPS:
                raise KeyError(f"unknown op {item['op']!r}")
        lo, hi = traffic["text_len"]
        if not 0 < lo <= hi <= self.max_len:
            raise ValueError("text_len out of range")
        if not all(0 < int(m["pattern_len"]) <= lo for m in traffic["mix"]):
            raise ValueError("a pattern_len is longer than the shortest "
                             "text")
        rng = traffic_gen.rng(seed, traffic_gen.STREAMS["pool"])
        self.texts = []
        for _ in range(int(traffic["pool"]["texts"])):
            n = int(rng.integers(lo, hi + 1))
            self.texts.append("".join(map(chr, rng.integers(*PRINTABLE,
                                                            size=n))))

    def keygen(self):
        from tfhe_tpu_torch.shortint import ServerKey
        from tfhe_tpu_torch.strings.batched import BatchedStringOps

        self.params = program.parameters(self.cfg)
        cks = program.client_key(self.params, self.small, self.glwe,
                                 self.seed, self.device)
        self.server = ServerKey(cks)
        self.strings = BatchedStringOps(self.server)

    def prepare(self):
        msg = self.enc.message_modulus
        digs = torch.tensor([[clear.digits(c, self.blocks_per_char, msg)
                              for c in clear.padded(t, self.max_len)]
                             for t in self.texts])
        self.pool = lwe.encrypt(self.enc, self.glwe.reshape(-1), digs,
                                lwe.generator(self.seed, 2, self.device))

    def submit(self, req) -> torch.Tensor:
        blocks = self.pool[req["index"]]
        sz = blocks.shape[-1]
        if req["op"] == "contains":
            return self.strings.contains(blocks, req["pattern"])
        found, firsts = self.strings.find(blocks, req["pattern"])
        return torch.cat([found[:, None], firsts], dim=1).reshape(-1, sz)

    def close(self):
        self.pool = self.strings = self.server = None

    def make(self, kind: dict, rng) -> dict:
        page = rng.choice(len(self.texts), size=self.batch, replace=False)
        plen = int(kind["pattern_len"])
        if rng.random() < float(self.traffic["pattern_from_text"]):
            text = self.texts[int(page[rng.integers(self.batch)])]
            start = int(rng.integers(len(text) - plen + 1))
            pattern = text[start:start + plen]
        else:
            pattern = "".join(map(chr, rng.integers(*PRINTABLE, size=plen)))
        return {"op": kind["op"], "pattern": pattern, "page": page.tolist(),
                "index": torch.as_tensor(page, device=self.device)}

    def kind(self, req) -> str:
        return f"{req['op']}.{len(req['pattern'])}"

    def ops(self, req) -> int:
        return self.batch

    def answer(self, req, bits: int = 0) -> list:
        """`bits` below the configuration's char_bits compares chars on
        that many low bits: the control's answer."""
        fn = (clear.contains_answer if req["op"] == "contains"
              else clear.find_answer)
        return [v for i in req["page"]
                for v in fn(self.texts[i], req["pattern"], self.max_len,
                            bits or self.char_bits)]
