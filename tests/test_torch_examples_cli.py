"""The port's string CLI (python -m tfhe_tpu_torch.examples.fhe_strings_cli)
with --device cpu on a 2-character string at the test parameters: every
op's line says ok against Python's `str`, none says MISMATCH; without
--device it asks for the card."""

import sys

import pytest
import torch

from tfhe_tpu_torch.examples import fhe_strings_cli

OPS = ("eq", "contains", "starts_with", "ends_with", "len", "is_empty",
       "find", "to_uppercase", "to_lowercase", "trim", "concat",
       "repeat(2)", "replace", "split")


@pytest.fixture
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.usefixtures("one_torch_thread")
def test_cli_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["fhe_strings_cli", "ab", "b",
                                      "--device", "cpu"])
    fhe_strings_cli.main()
    out = capsys.readouterr().out
    assert "MISMATCH" not in out
    lines = {ln.split()[0]: ln for ln in out.splitlines() if ln.strip()}
    for op in OPS:
        assert lines[op].rstrip().endswith("ok"), lines[op]
    if not torch.cuda.is_available():
        monkeypatch.setattr(sys, "argv", ["fhe_strings_cli", "ab", "b"])
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fhe_strings_cli.main()
