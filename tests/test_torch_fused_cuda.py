"""The single-program radix ops on a card: each op of
IntegerServerKey(fused=True) replayed from its CUDA graph == the same chain
run eagerly on the card == the port on the CPU, word for word, with keys
from one seed at PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST and 4 blocks, in
every classic blind-rotation mode that a graph captures; every result
decrypted right.  Marked `cuda`: it skips where there is no card; on one,
run `python -m pytest -m cuda --noconftest tests/test_torch_fused_cuda.py`
(tests/conftest.py imports JAX, which is not needed here)."""

import numpy as np
import pytest
import torch

from tfhe_tpu_torch import integer, shortint
from tfhe_tpu_torch.params import PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST as P

pytestmark = pytest.mark.cuda

NB = 4
MOD = 4 ** NB
SEED = 2024
X, Y = 201, 77
OPS = {  # name: (the IntegerServerKey call, the clear result)
    "add": (lambda k, a, b, c: k.add_parallelized(a, b), (X + Y) % MOD),
    "sub": (lambda k, a, b, c: k.sub_parallelized(a, b), (X - Y) % MOD),
    "neg": (lambda k, a, b, c: k.neg_parallelized(a), -X % MOD),
    "mul": (lambda k, a, b, c: k.mul_parallelized(a, b), X * Y % MOD),
    "eq": (lambda k, a, b, c: k.eq_parallelized(a, b), False),
    "lt": (lambda k, a, b, c: k.lt_parallelized(a, b), False),
    "bxor": (lambda k, a, b, c: k.bitxor_parallelized(a, b), X ^ Y),
    "select": (lambda k, a, b, c: k.if_then_else_parallelized(c, a, b), X),
    "max": (lambda k, a, b, c: k.max_parallelized(a, b), max(X, Y)),
}


@pytest.fixture(scope="module")
def pairs():
    """(client key, fused server key, a, b, cond) on the card and the
    CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = {}
    for where in ("cuda", "cpu"):
        cks, sks = integer.gen_keys_radix(P, NB, seed=SEED, device=where)
        fused = integer.IntegerServerKey(sks.key, fused=True)
        out[where] = (cks, fused, cks.encrypt(X), cks.encrypt(Y),
                      cks.encrypt_bool(True))
    return out


def _blocks(r):
    return r.blocks if hasattr(r, "blocks") else r.block


@pytest.mark.parametrize("op", sorted(OPS))
def test_graph_replay_equals_eager_and_cpu(pairs, op):
    fn, want = OPS[op]
    cks, key, a, b, c = pairs["cuda"]
    replayed = [fn(key, a, b, c) for _ in range(2)]  # capture, then replay
    assert any(k[0] == op for k in key._fused_ops._graphs), \
        "no CUDA graph captured"
    args = [x.block if hasattr(x, "block") else x.blocks
            for x in ((c, a, b) if op == "select" else
                      (a,) if op == "neg" else (a, b))]
    eager = key._fused_ops.try_op(op, *args, graph=False)
    cpu = _blocks(fn(pairs["cpu"][1], *pairs["cpu"][2:]))
    for r in replayed:
        assert torch.equal(_blocks(r).data, eager.data)
        assert torch.equal(_blocks(r).data.cpu(), cpu.data)
        assert np.array_equal(_blocks(r).degrees, cpu.degrees)
    dec = cks.decrypt_bool if isinstance(want, bool) else cks.decrypt
    assert dec(replayed[-1]) == want


@pytest.mark.parametrize("mode", ["scan1", "scan1w", "scan3", "grid",
                                  "mega"])
def test_every_mode_captures(pairs, mode):
    """A bitxor (one PBS batch) captured in each blind-rotation schedule:
    equal to the CPU's words."""
    cks, key, a, b, _ = pairs["cuda"]
    raw = key.key
    k = integer.IntegerServerKey(shortint.ServerKey.from_raw(
        P, raw.raw_bsk, raw.raw_ksk, device=raw.device, mode=mode),
        fused=True)
    got = k.bitxor_parallelized(a, b)
    cpu = pairs["cpu"][1].bitxor_parallelized(*pairs["cpu"][2:4])
    assert torch.equal(got.blocks.data.cpu(), cpu.blocks.data)
