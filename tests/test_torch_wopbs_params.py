"""The port's copies of the WoPBS and compact-public-key parameters equal
the reference's field by field: `WopbsParameters`, the two shortint WoPBS
sets, and every set of the `wopbs_params` (126) and `compact_pk_params`
(56) catalogs."""

import dataclasses

import pytest

from tfhe_tpu import params as ref_params
from tfhe_tpu.params import compact_pk_params as ref_compact
from tfhe_tpu.params import wopbs_params as ref_wopbs

from tfhe_tpu_torch import params
from tfhe_tpu_torch.params import compact_pk_params, wopbs_params


def _same(a, b):
    assert type(a).__name__ == type(b).__name__
    fa, fb = dataclasses.asdict(a), dataclasses.asdict(b)
    if "encryption_key_choice" in fa:
        fa["encryption_key_choice"] = fa["encryption_key_choice"].value
        fb["encryption_key_choice"] = fb["encryption_key_choice"].value
    assert fa == fb
    for prop in ("glwe_size", "big_lwe_dimension", "total_modulus", "delta",
                 "max_degree", "ciphertext_lwe_size"):
        assert getattr(a, prop) == getattr(b, prop)


@pytest.mark.parametrize("catalog", ["wopbs", "compact_pk"])
def test_catalog_copied_verbatim(catalog):
    mine, ref = {"wopbs": (wopbs_params, ref_wopbs),
                 "compact_pk": (compact_pk_params, ref_compact)}[catalog]
    assert len(mine.ALL) == len(ref.ALL) == {"wopbs": 126,
                                             "compact_pk": 56}[catalog]
    for a, b in zip(mine.ALL, ref.ALL):
        _same(a, b)
        assert getattr(mine, a.name) is a


def test_shortint_wopbs_sets_and_type():
    for name in ("WOPBS_PARAM_MESSAGE_2_CARRY_2_KS_PBS",
                 "WOPBS_PARAM_MESSAGE_2_CARRY_2_TEST"):
        _same(getattr(params, name), getattr(ref_params, name))
        assert isinstance(getattr(params, name), params.WopbsParameters)
    assert [f.name for f in dataclasses.fields(params.WopbsParameters)] == \
        [f.name for f in dataclasses.fields(ref_params.WopbsParameters)]


def test_wide_sets_of_the_catalog():
    """28 sets need more than the core's 9-digit variant; every one is
    within its 18-digit variant."""
    wide = [p for p in wopbs_params.ALL if p.pbs_level * p.glwe_size > 9]
    assert len(wide) == 28
    assert max(p.pbs_level * p.glwe_size for p in wide) == 18
    assert sorted({p.pbs_level * p.glwe_size for p in wide}) == [12, 15, 18]
