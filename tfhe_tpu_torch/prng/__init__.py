"""AES-128-CTR forkable CSPRNG + samplers (ref: concrete-csprng/)."""

from .aes import Aes128, native_library
from .stream import AesCtrStream, Seeder, system_seeder, ForkError
from .generators import SecretRandomGenerator, EncryptionRandomGenerator
from . import sampling

__all__ = [
    "Aes128",
    "native_library",
    "AesCtrStream",
    "Seeder",
    "system_seeder",
    "ForkError",
    "SecretRandomGenerator",
    "EncryptionRandomGenerator",
    "sampling",
]
