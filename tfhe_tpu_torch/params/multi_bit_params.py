"""Multi-bit parameter sets, copied verbatim from
`tfhe_tpu/params/multi_bit_params.py`
(ref: tfhe/src/shortint/parameters/multi_bit.rs)."""

from .types import MultiBitPBSParameters


PARAM_MULTI_BIT_MESSAGE_1_CARRY_1_GROUP_2_KS_PBS = MultiBitPBSParameters(
    name="PARAM_MULTI_BIT_MESSAGE_1_CARRY_1_GROUP_2_KS_PBS",
    lwe_dimension=764,
    glwe_dimension=3,
    polynomial_size=512,
    lwe_modular_std_dev=0.000006025673585415336,
    glwe_modular_std_dev=0.0000000000039666089171633006,
    pbs_base_log=18,
    pbs_level=1,
    ks_base_log=6,
    ks_level=2,
    message_modulus=2,
    carry_modulus=2,
    grouping_factor=2,
)

PARAM_MULTI_BIT_MESSAGE_2_CARRY_2_GROUP_2_KS_PBS = MultiBitPBSParameters(
    name="PARAM_MULTI_BIT_MESSAGE_2_CARRY_2_GROUP_2_KS_PBS",
    lwe_dimension=818,
    glwe_dimension=1,
    polynomial_size=2048,
    lwe_modular_std_dev=0.000002226459789930014,
    glwe_modular_std_dev=0.0000000000000003152931493498455,
    pbs_base_log=22,
    pbs_level=1,
    ks_base_log=5,
    ks_level=3,
    message_modulus=4,
    carry_modulus=4,
    grouping_factor=2,
)

PARAM_MULTI_BIT_MESSAGE_3_CARRY_3_GROUP_2_KS_PBS = MultiBitPBSParameters(
    name="PARAM_MULTI_BIT_MESSAGE_3_CARRY_3_GROUP_2_KS_PBS",
    lwe_dimension=922,
    glwe_dimension=1,
    polynomial_size=8192,
    lwe_modular_std_dev=0.0000003272369292345697,
    glwe_modular_std_dev=0.0000000000000000002168404344971009,
    pbs_base_log=14,
    pbs_level=2,
    ks_base_log=4,
    ks_level=4,
    message_modulus=8,
    carry_modulus=8,
    grouping_factor=2,
)

PARAM_MULTI_BIT_MESSAGE_1_CARRY_1_GROUP_3_KS_PBS = MultiBitPBSParameters(
    name="PARAM_MULTI_BIT_MESSAGE_1_CARRY_1_GROUP_3_KS_PBS",
    lwe_dimension=765,
    glwe_dimension=3,
    polynomial_size=512,
    lwe_modular_std_dev=0.000005915594083804978,
    glwe_modular_std_dev=0.0000000000039666089171633006,
    pbs_base_log=18,
    pbs_level=1,
    ks_base_log=6,
    ks_level=2,
    message_modulus=2,
    carry_modulus=2,
    grouping_factor=3,
)

PARAM_MULTI_BIT_MESSAGE_2_CARRY_2_GROUP_3_KS_PBS = MultiBitPBSParameters(
    name="PARAM_MULTI_BIT_MESSAGE_2_CARRY_2_GROUP_3_KS_PBS",
    lwe_dimension=888,
    glwe_dimension=1,
    polynomial_size=2048,
    lwe_modular_std_dev=0.0000006125031601933181,
    glwe_modular_std_dev=0.0000000000000003152931493498455,
    pbs_base_log=21,
    pbs_level=1,
    ks_base_log=7,
    ks_level=2,
    message_modulus=4,
    carry_modulus=4,
    grouping_factor=3,
)

PARAM_MULTI_BIT_MESSAGE_3_CARRY_3_GROUP_3_KS_PBS = MultiBitPBSParameters(
    name="PARAM_MULTI_BIT_MESSAGE_3_CARRY_3_GROUP_3_KS_PBS",
    lwe_dimension=972,
    glwe_dimension=1,
    polynomial_size=8192,
    lwe_modular_std_dev=0.00000013016688349592805,
    glwe_modular_std_dev=0.0000000000000000002168404344971009,
    pbs_base_log=14,
    pbs_level=2,
    ks_base_log=6,
    ks_level=3,
    message_modulus=8,
    carry_modulus=8,
    grouping_factor=3,
)


ALL = [
    PARAM_MULTI_BIT_MESSAGE_1_CARRY_1_GROUP_2_KS_PBS,
    PARAM_MULTI_BIT_MESSAGE_2_CARRY_2_GROUP_2_KS_PBS,
    PARAM_MULTI_BIT_MESSAGE_3_CARRY_3_GROUP_2_KS_PBS,
    PARAM_MULTI_BIT_MESSAGE_1_CARRY_1_GROUP_3_KS_PBS,
    PARAM_MULTI_BIT_MESSAGE_2_CARRY_2_GROUP_3_KS_PBS,
    PARAM_MULTI_BIT_MESSAGE_3_CARRY_3_GROUP_3_KS_PBS,
]
