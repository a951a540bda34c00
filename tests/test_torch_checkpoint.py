"""The port's checkpoint/resume subsystem (tfhe_tpu_torch.parallel.
checkpoint) on the CPU: the four cases of tests/test_checkpoint.py (round
trip, no failure, crash and resume with only the remaining chunks run,
transient retry) on the port's keys, and checkpoints written by either
package loaded by the other's CheckpointManager with equal words and
equal `.bin` bytes (the manifest's time stamp differs), at
PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST."""

import os

import numpy as np
import pytest
import torch

from tfhe_tpu import shortint as ref_shortint
from tfhe_tpu.parallel import CheckpointManager as RefCheckpointManager
from tfhe_tpu.params import PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST as REF_P

from tfhe_tpu_torch import shortint
from tfhe_tpu_torch.ops.torus import to_numpy, to_tensor
from tfhe_tpu_torch.parallel import CheckpointManager, ResumableBatchRunner
from tfhe_tpu_torch.params import PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST as P
from tfhe_tpu_torch.shortint.ciphertext import ShortintBatch

SEED = 909


@pytest.fixture(scope="module")
def keys():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield shortint.gen_keys(P, seed=SEED, device="cpu")
    torch.set_num_threads(threads)


def _wrap(arr):
    return ShortintBatch(
        data=arr, degrees=np.full(arr.shape[0], 3, dtype=np.int64),
        message_modulus=P.message_modulus, carry_modulus=P.carry_modulus)


def _unwrap(obj):
    return obj.data


def _lut_fn(sks, f, calls=None, fail_at=None):
    lut = sks.generate_lookup_table(f)

    def fn(chunk):
        if calls is not None:
            calls.append(1)
            if len(calls) == fail_at:
                raise RuntimeError("injected device loss")
        return sks.apply_lookup_table_batch(_wrap(chunk), lut).data

    return fn


def test_checkpoint_manager_roundtrip(tmp_path, keys):
    cks, _ = keys
    mgr = CheckpointManager(str(tmp_path), device="cpu")
    batch = cks.encrypt_batch([1, 2, 3])
    mgr.save(0, {"chunk": batch})
    mgr.save(1, {"chunk": batch})
    assert mgr.latest_step() == 1
    loaded = mgr.load(0)["chunk"]
    assert torch.equal(loaded.data, batch.data)
    assert loaded.data.device == torch.device("cpu")
    # a completed checkpoint is never overwritten
    mgr.save(1, {"chunk": cks.encrypt_batch([0])})
    assert torch.equal(mgr.load_latest()[1]["chunk"].data, batch.data)


def test_resumable_run_no_failure(tmp_path, keys):
    cks, sks = keys
    msgs = np.arange(16) % 4
    ct = cks.encrypt_batch(msgs)
    runner = ResumableBatchRunner(
        CheckpointManager(str(tmp_path), device="cpu"), 4)
    out = runner.run(_lut_fn(sks, lambda x: (x + 1) % 4), ct.data, _wrap,
                     _unwrap)
    assert isinstance(out, torch.Tensor) and out.shape == ct.data.shape
    assert cks.decrypt_batch(out).tolist() == ((msgs + 1) % 4).tolist()


def test_resume_after_crash(tmp_path, keys):
    """Crash mid-job, restart, resume from the checkpoint: completed chunks
    are not recomputed and the result equals an uninterrupted run's."""
    cks, sks = keys
    msgs = np.arange(16) % 4
    ct = cks.encrypt_batch(msgs)
    f = lambda x: (3 * x) % 4  # noqa: E731
    calls = []
    mgr = CheckpointManager(str(tmp_path / "job"), device="cpu")
    runner = ResumableBatchRunner(mgr, 4, max_retries=0)
    with pytest.raises(RuntimeError, match="injected"):
        runner.run(_lut_fn(sks, f, calls, fail_at=3), ct.data, _wrap,
                   _unwrap)
    assert mgr.latest_step() == 1  # chunks 0 and 1 completed

    calls.clear()  # "restart": a fresh runner resumes where the old died
    runner2 = ResumableBatchRunner(mgr, 4, max_retries=0)
    out = runner2.run(_lut_fn(sks, f, calls), ct.data, _wrap, _unwrap)
    assert len(calls) == 2  # only the 2 remaining chunks ran
    assert cks.decrypt_batch(out).tolist() == ((3 * msgs) % 4).tolist()
    whole = ResumableBatchRunner(
        CheckpointManager(str(tmp_path / "whole"), device="cpu"), 4).run(
            _lut_fn(sks, f), ct.data, _wrap, _unwrap)
    assert torch.equal(out, whole)


def test_retry_transient_failure(tmp_path, keys):
    cks, sks = keys
    msgs = np.array([0, 1, 2, 3])
    ct = cks.encrypt_batch(msgs)
    attempts = []
    runner = ResumableBatchRunner(
        CheckpointManager(str(tmp_path), device="cpu"), 4, max_retries=2,
        backoff_s=0.01)
    out = runner.run(_lut_fn(sks, lambda x: x, attempts, fail_at=1),
                     ct.data, _wrap, _unwrap)
    assert len(attempts) == 2
    assert cks.decrypt_batch(out).tolist() == msgs.tolist()


def test_checkpoints_cross_between_packages(tmp_path):
    rcks, _ = ref_shortint.gen_keys(REF_P, seed=SEED)
    rbatch = rcks.encrypt_batch([3, 1, 2, 0, 1])
    batch = ShortintBatch(data=to_tensor(rbatch.data, "cpu"),
                          degrees=rbatch.degrees, noise=rbatch.noise,
                          message_modulus=rbatch.message_modulus,
                          carry_modulus=rbatch.carry_modulus)
    # the port writes, the reference reads; and the reverse
    CheckpointManager(str(tmp_path / "port"), device="cpu").save(
        4, {"chunk": batch})
    RefCheckpointManager(str(tmp_path / "ref")).save(4, {"chunk": rbatch})
    got_ref = RefCheckpointManager(str(tmp_path / "port")).load_latest()
    got_port = CheckpointManager(str(tmp_path / "ref"),
                                 device="cpu").load_latest()
    assert got_ref[0] == got_port[0] == 4
    assert np.array_equal(np.asarray(got_ref[1]["chunk"].data), rbatch.data)
    assert np.array_equal(to_numpy(got_port[1]["chunk"].data), rbatch.data)
    assert np.array_equal(got_port[1]["chunk"].degrees, rbatch.degrees)
    step_dir = "host0_step00000004"
    assert sorted(os.listdir(tmp_path / "port" / step_dir)) == sorted(
        os.listdir(tmp_path / "ref" / step_dir))
    assert (tmp_path / "port" / step_dir / "chunk.bin").read_bytes() == \
        (tmp_path / "ref" / step_dir / "chunk.bin").read_bytes()
