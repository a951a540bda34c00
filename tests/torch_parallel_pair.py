"""The reference's side of the port's multi-rank mesh tests
(tests/test_torch_parallel_ranks*.py): its keys from the workers' seed, the
inputs encrypted by its client key, and each job's result through
tfhe_tpu.parallel.fused's UNSHARDED chain, each PBS batch through its
shortint key's per-shape PBS program.  The reference's own tests assert
that its sharded results equal these bit for bit (tests/test_mesh.py:
107-130, :215-227), so the port's sharded words are held against them.
Then the workers run and their words are compared, with tolerance 0."""

import json
import os

import numpy as np
import pytest

import tfhe_tpu.parallel.fused as RF
from tfhe_tpu import shortint as ref_shortint
from tfhe_tpu.params import PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST as REF_P
from tfhe_tpu.strings.client_key import NUMBER_BLOCKS

from torch_parallel_worker import SEED, join_world, spawn_world

MSG = REF_P.message_modulus
TEXTS = ["hello", "help!", "ohhel", "lohel", "hhhhh", "xxxxx", "hel",
         "zhelz"]  # tests/test_mesh.py:141-147
PATTERN = "hel"


def ref_keys():
    return ref_shortint.gen_keys(REF_P, seed=SEED)


def radix_blocks(cks, vals, nb):
    return np.stack([
        cks.encrypt_batch([(int(v) // MSG**j) % MSG for j in range(nb)]).data
        for v in vals])


def text_blocks(cks, texts):
    n = max(len(t) for t in texts)

    def enc(t):
        chars = [ord(c) for c in t] + [0] * (n - len(t))
        digs = [(c // MSG**d) % MSG for c in chars
                for d in range(NUMBER_BLOCKS)]
        return cks.encrypt_batch(np.asarray(digs, np.uint64)).data.reshape(
            n, NUMBER_BLOCKS, -1)

    return np.stack([enc(t) for t in texts])


def decrypt_radix(cks, words):
    return [sum(int(v) * MSG**j for j, v in enumerate(cks.decrypt_batch(row)))
            % MSG**words.shape[1] for row in words]


def _carry_accs(sks):
    msg = MSG
    return (
        sks.generate_lookup_table(
            lambda v: 2 if v >= msg else (1 if v == msg - 1 else 0)).acc,
        sks.generate_lookup_table_bivariate(
            lambda cur, prev: min(prev if cur == 1 else cur, 2)).acc.acc,
        sks.generate_lookup_table(lambda x: 1 if x == 2 else 0).acc,
        sks.generate_lookup_table(lambda x: x % msg).acc)


def reference(job, sks, inputs):
    """The reference's unsharded chain for `job` on the inputs (uint64)."""
    msg = MSG
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(RF, "keyswitch_then_pbs",
                   lambda ksk, bsk, acc, flat: sks._pbs_device(flat, acc))
        if job in ("blockshard_add", "sharded_add"):
            out = RF.fused_radix_add(sks.ksk, sks.bsk, *_carry_accs(sks),
                                     inputs["a"], inputs["b"],
                                     message_modulus=msg)
        elif job == "sharded_mul":
            accs = (  # tests/test_mesh.py:112-125
                sks.generate_lookup_table_bivariate(
                    lambda x, y: (x * y) % msg).acc.acc,
                sks.generate_lookup_table_bivariate(
                    lambda x, y: (x * y) // msg).acc.acc,
                sks.generate_lookup_table(lambda x: x % msg).acc,
                sks.generate_lookup_table(lambda x: x // msg).acc,
            ) + _carry_accs(sks)[:3]
            out = RF.fused_radix_mul(sks.ksk, sks.bsk, *accs, inputs["a"],
                                     inputs["b"], message_modulus=msg,
                                     carry_modulus=REF_P.carry_modulus)
        elif job == "contains":
            pattern = str(inputs["pattern"])
            accs = (
                sks.generate_lookup_table_bivariate(
                    lambda x, y: 0 if x == y else (1 if x < y else 2)).acc.acc,
                sks.generate_lookup_table_bivariate(
                    lambda high, low: min(low if high == 0 else high,
                                          2)).acc.acc,
                sks.generate_lookup_table(lambda v: int(v == 0)).acc,
                sks.generate_lookup_table_bivariate(
                    lambda x, y: int(bool(x) and bool(y))).acc.acc,
                sks.generate_lookup_table_bivariate(
                    lambda x, y: int(bool(x) or bool(y))).acc.acc)
            pat_digits = tuple(
                tuple((ord(c) // msg**d) % msg for d in range(NUMBER_BLOCKS))
                for c in pattern)
            out = RF.fused_strings_contains(
                sks.ksk, sks.bsk, *accs, inputs["chars"],
                pat_digits=pat_digits, message_modulus=msg,
                delta=REF_P.delta)
        else:
            raise ValueError(job)
    return np.asarray(out)


def run_worlds(tmp_path_factory, worlds, jobs, sks):
    """Each job's reference words (computed while the ranks run) and, for
    each world size, per job {"words": [each rank's gathered words],
    "ranks": [each rank's record]}, and under "mesh" each rank's mesh
    facts."""
    started = []
    for world in worlds:
        workdir = str(tmp_path_factory.mktemp(f"world{world}"))
        for job, inputs in jobs.items():
            np.savez(os.path.join(workdir, f"{job}_in.npz"), **inputs)
        started.append((world, workdir, spawn_world(world, workdir, jobs)))
    refs = {job: reference(job, sks, inputs) for job, inputs in jobs.items()}
    runs = {}
    for world, workdir, context in started:
        join_world(context, world)
        runs[world] = {job: dict(
            words=[np.load(os.path.join(workdir, f"{job}_out{r}.npy"))
                   for r in range(world)],
            ranks=[_read(workdir, f"{job}_rank{r}.json")
                   for r in range(world)]) for job in jobs}
        runs[world]["mesh"] = [_read(workdir, f"mesh_rank{r}.json")
                               for r in range(world)]
    return refs, runs


def _read(workdir, name):
    with open(os.path.join(workdir, name)) as f:
        return json.load(f)
