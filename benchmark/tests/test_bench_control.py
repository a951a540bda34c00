"""The check fails the control and every fault the cells can have, at a
toy size on the CPU: the control (the clear function at the precision
below the configuration's in the program's place), and a run of the
harness with the timed path broken under it: a PBS that returns its
state unchanged, a batch whose second half is left out (its rows given
the first half's), and an answer altered where it is produced (one block
of every PBS batch's output off by one).  The cells run on one card, so
no exchange between cards can be left out."""

import pytest
import torch

from benchmark import control, harness


@pytest.mark.parametrize("cell", ["toy_api", "toy_batched", "toy_strings"])
def test_control_is_not_correct(toy_root, cell):
    bench = harness.Benchmark(toy_root)
    for seed in (11, 12, 13):
        r = control.control_readings(bench, cell, seed, 100, "cpu")
        assert r["wrong_answers"] > 0 and r["wrong_blocks"] > 0, r


def _unchanged(orig):
    def pbs(ksk, bsk, lut, ct_big, mode=None):
        return ct_big.clone()
    return pbs


def _half(orig):
    def pbs(ksk, bsk, lut, ct_big, mode=None):
        h = (ct_big.shape[0] + 1) // 2
        lut_h = lut[:h] if lut.dim() == 3 else lut
        out = orig(ksk, bsk, lut_h, ct_big[:h], mode)
        return torch.cat([out, out[:ct_big.shape[0] - h]])
    return pbs


def _altered(orig):
    def pbs(ksk, bsk, lut, ct_big, mode=None):
        out = orig(ksk, bsk, lut, ct_big, mode)
        out[0, -1] += 1 << 59  # one more in the message of the first row
        return out
    return pbs


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered])
@pytest.mark.parametrize("cell", ["toy_api", "toy_batched", "toy_strings"])
def test_fault_is_not_correct(toy_root, monkeypatch, cell, fault):
    import tfhe_tpu_torch.core as core
    from tfhe_tpu_torch.integer import fused

    torch.set_num_threads(2)
    orig = core.keyswitch_then_pbs
    monkeypatch.setattr(core, "keyswitch_then_pbs", fault(orig))
    monkeypatch.setattr(fused, "keyswitch_then_pbs", fault(orig))
    bench = harness.Benchmark(toy_root)
    out = harness.run_cell(bench, cell, 2 ** 31 + 5, 0.5, trace=False,
                           device="cpu")
    assert out["correct"] is False, out["checks"]
