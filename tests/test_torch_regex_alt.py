"""The port's regex engine == tfhe_tpu's, word for word (tolerance 0):
the alternation and case-folding patterns of the table of
tests/test_examples.py, on texts of 5 characters (test_torch_regex.py)."""

import pytest

from test_torch_regex import CASES, check, string_keys  # noqa: F401
from torch_integer_pair import host_path_one_thread  # noqa: F401


@pytest.mark.parametrize("text,pattern,want", CASES[7:9])
def test_regex(string_keys, text, pattern, want):  # noqa: F811
    check(string_keys, text, pattern, want)
