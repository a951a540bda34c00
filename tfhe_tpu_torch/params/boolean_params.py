"""Named boolean parameter sets over the u32 torus (copy of
`tfhe_tpu/params/boolean_params.py`).

Values reproduced from the reference constants
(ref: tfhe/src/boolean/parameters/mod.rs:123-194).
"""

from .types import BooleanParameters, EncryptionKeyChoice

DEFAULT_PARAMETERS = BooleanParameters(
    name="DEFAULT_PARAMETERS",
    lwe_dimension=722,
    glwe_dimension=2,
    polynomial_size=512,
    lwe_modular_std_dev=0.000013071021089943935,
    glwe_modular_std_dev=0.00000004990272175010415,
    pbs_base_log=6,
    pbs_level=3,
    ks_base_log=3,
    ks_level=4,
    encryption_key_choice=EncryptionKeyChoice.SMALL,
)

DEFAULT_PARAMETERS_KS_PBS = BooleanParameters(
    name="DEFAULT_PARAMETERS_KS_PBS",
    lwe_dimension=664,
    glwe_dimension=2,
    polynomial_size=512,
    lwe_modular_std_dev=0.00003808282923459771,
    glwe_modular_std_dev=0.00000004990272175010415,
    pbs_base_log=6,
    pbs_level=3,
    ks_base_log=3,
    ks_level=4,
    encryption_key_choice=EncryptionKeyChoice.BIG,
)

PARAMETERS_ERROR_PROB_2_POW_MINUS_165 = BooleanParameters(
    name="PARAMETERS_ERROR_PROB_2_POW_MINUS_165",
    lwe_dimension=767,
    glwe_dimension=2,
    polynomial_size=1024,
    lwe_modular_std_dev=0.000005104350373791501,
    glwe_modular_std_dev=0.0000000009313225746154785,
    pbs_base_log=10,
    pbs_level=2,
    ks_base_log=3,
    ks_level=5,
    encryption_key_choice=EncryptionKeyChoice.SMALL,
)

PARAMETERS_ERROR_PROB_2_POW_MINUS_165_KS_PBS = BooleanParameters(
    name="PARAMETERS_ERROR_PROB_2_POW_MINUS_165_KS_PBS",
    lwe_dimension=700,
    glwe_dimension=1,
    polynomial_size=1024,
    lwe_modular_std_dev=0.0000196095987892077,
    glwe_modular_std_dev=0.00000004990272175010415,
    pbs_base_log=5,
    pbs_level=4,
    ks_base_log=2,
    ks_level=7,
    encryption_key_choice=EncryptionKeyChoice.BIG,
)

TFHE_LIB_PARAMETERS = BooleanParameters(
    name="TFHE_LIB_PARAMETERS",
    lwe_dimension=630,
    glwe_dimension=1,
    polynomial_size=1024,
    lwe_modular_std_dev=0.000030517578125,
    glwe_modular_std_dev=0.00000002980232238769531,
    pbs_base_log=7,
    pbs_level=3,
    ks_base_log=2,
    ks_level=8,
    encryption_key_choice=EncryptionKeyChoice.SMALL,
)

# Minimal insecure fixture for gate-heavy example tests (k=1, one level).
BOOLEAN_SHA_TEST_PARAMETERS = BooleanParameters(
    name="BOOLEAN_SHA_TEST_PARAMETERS",
    lwe_dimension=8,
    glwe_dimension=1,
    polynomial_size=256,
    lwe_modular_std_dev=0.0000000001,
    glwe_modular_std_dev=0.00000000000000029403601535432533,
    pbs_base_log=23,
    pbs_level=1,
    ks_base_log=4,
    ks_level=3,
    encryption_key_choice=EncryptionKeyChoice.SMALL,
)

# Insecure fixture parameters for fast tests (same shape of code path).
BOOLEAN_TEST_PARAMETERS = BooleanParameters(
    name="BOOLEAN_TEST_PARAMETERS",
    lwe_dimension=16,
    glwe_dimension=2,
    polynomial_size=256,
    lwe_modular_std_dev=0.000013071021089943935,
    glwe_modular_std_dev=0.00000004990272175010415,
    pbs_base_log=6,
    pbs_level=3,
    ks_base_log=3,
    ks_level=4,
    encryption_key_choice=EncryptionKeyChoice.SMALL,
)
