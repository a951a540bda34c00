"""The port's profiling helpers (tfhe_tpu_torch.utils.profiling) on the
CPU: OpTimer's case of tests/test_utils.py:38-46 and its records keyed as
the reference's, its synchronisation with the card once CUDA is
initialised, `trace(logdir)` writing a Chrome trace that holds an
`annotate`d region, and the region in the profile's key_averages()."""

import glob
import json

import torch

from tfhe_tpu.utils import OpTimer as RefOpTimer

from tfhe_tpu_torch.utils import OpTimer, annotate, profiling, trace


def test_op_timer():
    t = OpTimer()
    with t.measure("op_a"):
        sum(range(1000))
    with t.measure("op_a"):
        sum(range(1000))
    recs = t.records()
    assert len(recs) == 1 and recs[0]["samples"] == 2
    json.loads(t.dump_json())


def test_op_timer_records_match_the_reference():
    port, ref = OpTimer(), RefOpTimer()
    for timer in (port, ref):
        with timer.measure("op_b"):
            sum(range(100))
    got, want = port.records()[0], ref.records()[0]
    assert list(got) == list(want)
    assert got["name"] == want["name"] and got["unit"] == want["unit"]


def test_op_timer_waits_for_the_card(monkeypatch):
    syncs = []
    monkeypatch.setattr(profiling.torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(profiling.torch.cuda, "synchronize",
                        lambda: syncs.append(1))
    t = OpTimer()
    with t.measure("queued"):
        pass
    assert syncs == [1] and t.records()[0]["samples"] == 1


def test_trace_writes_an_annotated_region(tmp_path):
    x = torch.arange(4096, dtype=torch.int64)
    with trace(str(tmp_path)) as prof:
        with annotate("fhe_block"):
            (x * 3 + 1).sum()
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "fhe_block" for e in events)
    assert "fhe_block" in {e.key for e in prof.key_averages()}
