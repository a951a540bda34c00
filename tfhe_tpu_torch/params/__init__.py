"""Cryptographic parameter sets of the port's slice (classic shortint PBS)."""

from .types import ClassicPBSParameters, EncryptionKeyChoice, PBSOrder
from .shortint_params import (
    ALL_PARAMETER_SETS,
    PARAM_MESSAGE_1_CARRY_1_TEST,
    PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST,
    PARAM_MESSAGE_2_CARRY_2_KS_PBS,
    PARAM_MESSAGE_2_CARRY_2_TEST,
)

__all__ = [
    "ClassicPBSParameters",
    "EncryptionKeyChoice",
    "PBSOrder",
    "PARAM_MESSAGE_2_CARRY_2_KS_PBS",
    "PARAM_MESSAGE_2_CARRY_2_TEST",
    "PARAM_MESSAGE_1_CARRY_1_TEST",
    "PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST",
    "ALL_PARAMETER_SETS",
]
