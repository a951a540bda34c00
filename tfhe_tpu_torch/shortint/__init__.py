"""Shortint: few-bit message+carry integers over the u64 torus
(port of `tfhe_tpu/shortint`; ref: tfhe/src/shortint/)."""

from .ciphertext import CheckError, Ciphertext, ShortintBatch
from .client_key import ClientKey
from .server_key import BivariateLookupTable, LookupTable, ServerKey, gen_keys
from .compressed import (CompressedCiphertextList, CompressedServerKey,
                         encrypt_compressed_batch)
from .public_key import (CompactCiphertextList, CompactPublicKey,
                         CompressedCompactPublicKey, CompressedPublicKey,
                         PublicKey)
from .wopbs import ShortintWopbsLUT, WopbsKey, gen_keys_wopbs
from .key_switching_key import (PARAM_KEYSWITCH_1_1_KS_PBS_TO_2_2_KS_PBS,
                                KeySwitchingKey,
                                ShortintKeySwitchingParameters)

__all__ = [
    "CheckError", "Ciphertext", "ShortintBatch", "ClientKey", "ServerKey",
    "LookupTable", "BivariateLookupTable", "gen_keys",
    "CompressedServerKey", "CompressedCiphertextList",
    "encrypt_compressed_batch", "PublicKey", "CompactPublicKey",
    "CompactCiphertextList", "CompressedPublicKey",
    "CompressedCompactPublicKey", "KeySwitchingKey", "WopbsKey",
    "ShortintWopbsLUT", "gen_keys_wopbs", "ShortintKeySwitchingParameters",
    "PARAM_KEYSWITCH_1_1_KS_PBS_TO_2_2_KS_PBS",
]
