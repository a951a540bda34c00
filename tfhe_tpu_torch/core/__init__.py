"""Core crypto: keygen, encryption, keyswitch, programmable bootstrap.

Port of `tfhe_tpu/core` for the classic and multi-bit PBS paths, each in
both PBS orders, on the kernels' key layouts or the CRT-NTT layout, and
for the 128-bit torus; the packing keyswitch, WoPBS (`core.wopbs`), and the
public and seeded keys (`core.public_key`, `core.seeded`)."""

from .secret import GlweSecretKey, LweSecretKey, binary_ext_matrix, glwe_phase
from .encrypt import (decrypt_glwe, decrypt_lwe, encrypt_glwe_assign,
                      encrypt_lwe, trivial_lwe)
from .keygen import (PreparedKsk, generate_binary_glwe_secret_key,
                     generate_binary_lwe_secret_key, generate_bootstrap_key,
                     generate_keyswitch_key, prepare_ksk)
from .keyswitch import keyswitch
from .lut import fill_accumulator, fill_accumulator_u128, make_lut_glwe
from .pbs import (CLASSIC_MODES, NTT_MODE, blind_rotate, check_classic_mode,
                  keyswitch_then_pbs, modulus_switch, pbs_then_keyswitch,
                  prepare_classic_bsk, programmable_bootstrap, sample_extract,
                  sample_extract_u128)
from .u128_crypto import (decrypt_glwe_u128, decrypt_lwe_u128,
                          encrypt_glwe_preset_u128, encrypt_lwe_u128,
                          generate_binary_lwe_secret_key_u128,
                          generate_bootstrap_key_u128, glwe_phase_u128,
                          negacyclic_mul_binary)
from .multibit import (MULTI_BIT_MODES, PreparedMultiBitBskNtt,
                       check_multi_bit_mode, combine_key_bits,
                       generate_multi_bit_bootstrap_key,
                       keyswitch_then_multi_bit_pbs, multi_bit_blind_rotate,
                       multi_bit_pbs_then_keyswitch,
                       multi_bit_programmable_bootstrap, multi_bit_step_ntt,
                       prepare_multi_bit_bsk, prepare_multi_bit_bsk_ntt,
                       switched_subset_sums)
from ..ops.fused_pbs import PreparedBskCuda, prepare_bsk_cuda
from ..ops.fused_multibit import (PreparedMultiBitBskCuda,
                                  prepare_multi_bit_bsk_cuda)
from ..ops.polymul_ntt import PreparedBskNtt, prepare_bsk_ntt
from .packing_keyswitch import (generate_packing_keyswitch_key,
                                packing_keyswitch)

__all__ = [
    "LweSecretKey", "GlweSecretKey", "binary_ext_matrix", "glwe_phase",
    "encrypt_lwe", "decrypt_lwe", "encrypt_glwe_assign", "decrypt_glwe",
    "trivial_lwe",
    "generate_binary_lwe_secret_key", "generate_binary_glwe_secret_key",
    "generate_bootstrap_key", "generate_keyswitch_key", "prepare_ksk",
    "PreparedKsk", "PreparedBskCuda", "prepare_bsk_cuda",
    "keyswitch", "fill_accumulator", "make_lut_glwe",
    "modulus_switch", "blind_rotate", "sample_extract",
    "programmable_bootstrap", "keyswitch_then_pbs", "pbs_then_keyswitch",
    "combine_key_bits", "generate_multi_bit_bootstrap_key",
    "PreparedMultiBitBskCuda", "prepare_multi_bit_bsk_cuda",
    "switched_subset_sums", "multi_bit_blind_rotate",
    "multi_bit_programmable_bootstrap", "keyswitch_then_multi_bit_pbs",
    "multi_bit_pbs_then_keyswitch", "MULTI_BIT_MODES",
    "check_multi_bit_mode", "PreparedMultiBitBskNtt",
    "prepare_multi_bit_bsk_ntt", "prepare_multi_bit_bsk",
    "multi_bit_step_ntt",
    "PreparedBskNtt", "prepare_bsk_ntt", "NTT_MODE", "CLASSIC_MODES",
    "check_classic_mode", "prepare_classic_bsk", "fill_accumulator_u128",
    "sample_extract_u128", "encrypt_lwe_u128", "decrypt_lwe_u128",
    "encrypt_glwe_preset_u128", "decrypt_glwe_u128",
    "generate_binary_lwe_secret_key_u128", "generate_bootstrap_key_u128",
    "glwe_phase_u128", "negacyclic_mul_binary",
    "generate_packing_keyswitch_key", "packing_keyswitch",
]
