"""Named shortint parameter sets used by the port's shortint slice.

Values copied from `tfhe_tpu/params/shortint_params.py`
(ref: tfhe/src/shortint/parameters/mod.rs:598-760,
 tfhe/examples/fhe_strings/ciphertext.rs:75-105 for the insecure TEST sets).
"""

from .types import ClassicPBSParameters, MultiBitPBSParameters

# The workhorse parameter set: 2-bit message + 2-bit carry, 128-bit security,
# p_fail <= 2^-40.
PARAM_MESSAGE_2_CARRY_2_KS_PBS = ClassicPBSParameters(
    name="PARAM_MESSAGE_2_CARRY_2_KS_PBS",
    lwe_dimension=742,
    glwe_dimension=1,
    polynomial_size=2048,
    lwe_modular_std_dev=0.000007069849454709433,
    glwe_modular_std_dev=0.00000000000000029403601535432533,
    pbs_base_log=23,
    pbs_level=1,
    ks_base_log=3,
    ks_level=5,
    message_modulus=4,
    carry_modulus=4,
)

# "Fast but insecure" fixture parameters: same code path, toy dimensions.
PARAM_MESSAGE_2_CARRY_2_TEST = ClassicPBSParameters(
    name="PARAM_MESSAGE_2_CARRY_2_TEST",
    lwe_dimension=1,
    glwe_dimension=1,
    polynomial_size=256,
    lwe_modular_std_dev=0.000007069849454709433,
    glwe_modular_std_dev=0.00000000000000029403601535432533,
    pbs_base_log=23,
    pbs_level=1,
    ks_base_log=3,
    ks_level=5,
    message_modulus=4,
    carry_modulus=4,
)

PARAM_MESSAGE_1_CARRY_1_TEST = ClassicPBSParameters(
    name="PARAM_MESSAGE_1_CARRY_1_TEST",
    lwe_dimension=16,
    glwe_dimension=1,
    polynomial_size=256,
    lwe_modular_std_dev=0.000007069849454709433,
    glwe_modular_std_dev=0.00000000000000029403601535432533,
    pbs_base_log=23,
    pbs_level=1,
    ks_base_log=3,
    ks_level=5,
    message_modulus=2,
    carry_modulus=2,
)

# Insecure fixture with a non-trivial LWE dimension, so the keyswitch and
# blind-rotation loops are exercised.
PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST = ClassicPBSParameters(
    name="PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST",
    lwe_dimension=16,
    glwe_dimension=1,
    polynomial_size=256,
    lwe_modular_std_dev=0.000007069849454709433,
    glwe_modular_std_dev=0.00000000000000029403601535432533,
    pbs_base_log=23,
    pbs_level=1,
    ks_base_log=3,
    ks_level=5,
    message_modulus=4,
    carry_modulus=4,
)

# Insecure toy multi-bit fixture for fast tests (same role as
# PARAM_MESSAGE_2_CARRY_2_TEST).
PARAM_MULTI_BIT_MESSAGE_2_CARRY_2_GROUP_2_TEST = MultiBitPBSParameters(
    name="PARAM_MULTI_BIT_MESSAGE_2_CARRY_2_GROUP_2_TEST",
    lwe_dimension=16,
    glwe_dimension=1,
    polynomial_size=256,
    lwe_modular_std_dev=0.000007069849454709433,
    glwe_modular_std_dev=0.00000000000000029403601535432533,
    pbs_base_log=23,
    pbs_level=1,
    ks_base_log=3,
    ks_level=5,
    message_modulus=4,
    carry_modulus=4,
    grouping_factor=2,
)

ALL_PARAMETER_SETS = {
    p.name: p
    for p in [
        PARAM_MESSAGE_2_CARRY_2_KS_PBS,
        PARAM_MESSAGE_2_CARRY_2_TEST,
        PARAM_MESSAGE_1_CARRY_1_TEST,
        PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST,
    ]
}
