"""Named shortint parameter sets: the classic KS_PBS family, the two
compact-public-key sets (one in each PBS order), the two WoPBS sets and the
insecure TEST sets.

Values copied from `tfhe_tpu/params/shortint_params.py`
(ref: tfhe/src/shortint/parameters/mod.rs:598-760,
 shortint/parameters/parameters_compact_pk.rs:191-205, :613-627,
 parameters_wopbs_message_carry.rs:432-451,
 tfhe/examples/fhe_strings/ciphertext.rs:75-105 for the insecure TEST sets).
"""

from .types import (ClassicPBSParameters, EncryptionKeyChoice,
                    MultiBitPBSParameters, WopbsParameters)

PARAM_MESSAGE_1_CARRY_0_KS_PBS = ClassicPBSParameters(
    name="PARAM_MESSAGE_1_CARRY_0_KS_PBS",
    lwe_dimension=678,
    glwe_dimension=5,
    polynomial_size=256,
    lwe_modular_std_dev=0.000022810107419132102,
    glwe_modular_std_dev=0.00000000037411618952047216,
    pbs_base_log=15,
    pbs_level=1,
    ks_base_log=5,
    ks_level=2,
    message_modulus=2,
    carry_modulus=1,
)

PARAM_MESSAGE_1_CARRY_1_KS_PBS = ClassicPBSParameters(
    name="PARAM_MESSAGE_1_CARRY_1_KS_PBS",
    lwe_dimension=684,
    glwe_dimension=3,
    polynomial_size=512,
    lwe_modular_std_dev=0.00002043784477291318,
    glwe_modular_std_dev=0.0000000000034525330484572114,
    pbs_base_log=18,
    pbs_level=1,
    ks_base_log=4,
    ks_level=3,
    message_modulus=2,
    carry_modulus=2,
)

PARAM_MESSAGE_2_CARRY_1_KS_PBS = ClassicPBSParameters(
    name="PARAM_MESSAGE_2_CARRY_1_KS_PBS",
    lwe_dimension=742,
    glwe_dimension=2,
    polynomial_size=1024,
    lwe_modular_std_dev=0.000007069849454709433,
    glwe_modular_std_dev=0.00000000000000029403601535432533,
    pbs_base_log=23,
    pbs_level=1,
    ks_base_log=4,
    ks_level=3,
    message_modulus=4,
    carry_modulus=2,
)


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

PARAM_MESSAGE_3_CARRY_1_KS_PBS = ClassicPBSParameters(
    name="PARAM_MESSAGE_3_CARRY_1_KS_PBS",
    lwe_dimension=742,
    glwe_dimension=1,
    polynomial_size=2048,
    lwe_modular_std_dev=0.000007069849454709433,
    glwe_modular_std_dev=0.00000000000000029403601535432533,
    pbs_base_log=23,
    pbs_level=1,
    ks_base_log=3,
    ks_level=5,
    message_modulus=8,
    carry_modulus=2,
)

PARAM_MESSAGE_3_CARRY_3_KS_PBS = ClassicPBSParameters(
    name="PARAM_MESSAGE_3_CARRY_3_KS_PBS",
    lwe_dimension=864,
    glwe_dimension=1,
    polynomial_size=8192,
    lwe_modular_std_dev=0.000000757998020150446,
    glwe_modular_std_dev=0.0000000000000000002168404344971009,
    pbs_base_log=15,
    pbs_level=2,
    ks_base_log=3,
    ks_level=6,
    message_modulus=8,
    carry_modulus=8,
)

PARAM_MESSAGE_4_CARRY_0_KS_PBS = ClassicPBSParameters(
    name="PARAM_MESSAGE_4_CARRY_0_KS_PBS",
    lwe_dimension=742,
    glwe_dimension=1,
    polynomial_size=2048,
    lwe_modular_std_dev=0.000007069849454709433,
    glwe_modular_std_dev=0.00000000000000029403601535432533,
    pbs_base_log=23,
    pbs_level=1,
    ks_base_log=3,
    ks_level=5,
    message_modulus=16,
    carry_modulus=1,
)

PARAM_MESSAGE_4_CARRY_4_KS_PBS = ClassicPBSParameters(
    name="PARAM_MESSAGE_4_CARRY_4_KS_PBS",
    lwe_dimension=996,
    glwe_dimension=1,
    polynomial_size=32768,
    lwe_modular_std_dev=0.00000006767666038309478,
    glwe_modular_std_dev=0.0000000000000000002168404344971009,
    pbs_base_log=15,
    pbs_level=2,
    ks_base_log=3,
    ks_level=7,
    message_modulus=32,
    carry_modulus=32,
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

# Compact-public-key parameter sets (power-of-two encryption dimension so
# the Joye-style packing applies; ref: shortint/parameters/
# parameters_compact_pk.rs:191-205, :613-627).  The PBS_KS set encrypts
# under the small key and runs PBS then keyswitch.
PARAM_MESSAGE_2_CARRY_2_COMPACT_PK_KS_PBS = ClassicPBSParameters(
    name="PARAM_MESSAGE_2_CARRY_2_COMPACT_PK_KS_PBS",
    lwe_dimension=756,
    glwe_dimension=1,
    polynomial_size=2048,
    lwe_modular_std_dev=6.983104533665408e-06,
    glwe_modular_std_dev=3.152834667799722e-16,
    pbs_base_log=22,
    pbs_level=1,
    ks_base_log=3,
    ks_level=5,
    message_modulus=4,
    carry_modulus=4,
)

PARAM_MESSAGE_2_CARRY_2_COMPACT_PK_PBS_KS = ClassicPBSParameters(
    name="PARAM_MESSAGE_2_CARRY_2_COMPACT_PK_PBS_KS",
    lwe_dimension=1024,
    glwe_dimension=1,
    polynomial_size=2048,
    lwe_modular_std_dev=4.99029381172945e-8,
    glwe_modular_std_dev=3.15283466779972e-16,
    pbs_base_log=21,
    pbs_level=1,
    ks_base_log=8,
    ks_level=2,
    message_modulus=4,
    carry_modulus=4,
    encryption_key_choice=EncryptionKeyChoice.SMALL,
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

# WoPBS parameter sets (ref: shortint/parameters/
# parameters_wopbs_message_carry.rs:432-451)
WOPBS_PARAM_MESSAGE_2_CARRY_2_KS_PBS = WopbsParameters(
    name="WOPBS_PARAM_MESSAGE_2_CARRY_2_KS_PBS",
    lwe_dimension=769,
    glwe_dimension=1,
    polynomial_size=2048,
    lwe_modular_std_dev=0.0000043131554647504185,
    glwe_modular_std_dev=0.00000000000000029403601535432533,
    pbs_base_log=15,
    pbs_level=2,
    ks_base_log=6,
    ks_level=2,
    pfks_base_log=15,
    pfks_level=2,
    pfks_modular_std_dev=0.00000000000000029403601535432533,
    cbs_base_log=5,
    cbs_level=3,
    message_modulus=4,
    carry_modulus=4,
)

# Insecure toy WoPBS fixture for fast tests.
WOPBS_PARAM_MESSAGE_2_CARRY_2_TEST = WopbsParameters(
    name="WOPBS_PARAM_MESSAGE_2_CARRY_2_TEST",
    lwe_dimension=16,
    glwe_dimension=1,
    polynomial_size=256,
    lwe_modular_std_dev=0.0000000001,
    glwe_modular_std_dev=0.00000000000000029403601535432533,
    pbs_base_log=15,
    pbs_level=2,
    ks_base_log=6,
    ks_level=2,
    pfks_base_log=15,
    pfks_level=2,
    pfks_modular_std_dev=0.00000000000000029403601535432533,
    cbs_base_log=6,
    cbs_level=2,
    message_modulus=4,
    carry_modulus=4,
)

ALL_PARAMETER_SETS = {
    p.name: p
    for p in [
        PARAM_MESSAGE_1_CARRY_0_KS_PBS,
        PARAM_MESSAGE_1_CARRY_1_KS_PBS,
        PARAM_MESSAGE_2_CARRY_1_KS_PBS,
        PARAM_MESSAGE_2_CARRY_2_KS_PBS,
        PARAM_MESSAGE_3_CARRY_1_KS_PBS,
        PARAM_MESSAGE_3_CARRY_3_KS_PBS,
        PARAM_MESSAGE_4_CARRY_0_KS_PBS,
        PARAM_MESSAGE_4_CARRY_4_KS_PBS,
        PARAM_MESSAGE_2_CARRY_2_COMPACT_PK_KS_PBS,
        PARAM_MESSAGE_2_CARRY_2_COMPACT_PK_PBS_KS,
        PARAM_MESSAGE_2_CARRY_2_TEST,
        PARAM_MESSAGE_1_CARRY_1_TEST,
        PARAM_MESSAGE_2_CARRY_2_COMPACT_TEST,
    ]
}
