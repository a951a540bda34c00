"""Plain LWE arithmetic on the 64-bit torus for the benchmark's keys,
inputs and checks.

The benchmark draws the secret keys itself and encrypts every input block
itself, so the check decrypts the program's outputs with a key the
program did not make.  Words are int64 tensors whose adds and products
wrap modulo 2^64, as the torus's u64 words do.  A block encodes
`value * delta` with delta = 2^63 / (message_modulus * carry_modulus):
the top bit is the padding bit, the next log2(msg * carry) bits the
message and carry (ref: TFHE-rs shortint/engine encoding).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

TORUS_BITS = 64


@dataclass(frozen=True)
class Encoding:
    """The shortint encoding of one parameter set, from the configuration's
    numbers."""

    message_modulus: int
    carry_modulus: int
    lwe_dimension: int       # n, the small key (keyswitch output)
    glwe_dimension: int      # k
    polynomial_size: int     # N; the big key has k*N bits
    glwe_std: float          # noise of an encryption under the big key

    @classmethod
    def from_config(cls, parameters: dict) -> "Encoding":
        return cls(parameters["message_modulus"], parameters["carry_modulus"],
                   parameters["lwe_dimension"], parameters["glwe_dimension"],
                   parameters["polynomial_size"],
                   parameters["glwe_modular_std_dev"])

    @property
    def log_delta(self) -> int:
        total = self.message_modulus * self.carry_modulus
        if total & (total - 1):
            raise ValueError("message_modulus * carry_modulus must be a "
                             "power of two")
        return TORUS_BITS - 1 - (total.bit_length() - 1)

    @property
    def big_dimension(self) -> int:
        return self.glwe_dimension * self.polynomial_size


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A torch generator on `device` for one named stream of a run's seed
    (the seed may exceed 32 bits)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (1 << 63))
    return g


def draw_secret_keys(enc: Encoding, seed: int, device):
    """(small key bits [n], GLWE key bits [k, N]) as int64 0/1 tensors."""
    g = generator(seed, 1, device)
    small = torch.randint(0, 2, (enc.lwe_dimension,), generator=g,
                          device=device)
    glwe = torch.randint(0, 2, (enc.glwe_dimension, enc.polynomial_size),
                         generator=g, device=device)
    return small, glwe


def uniform_words(shape, g: torch.Generator, device) -> torch.Tensor:
    """Uniform 64-bit words as int64 (two 32-bit draws a word)."""
    hi = torch.randint(0, 1 << 32, shape, generator=g, device=device)
    lo = torch.randint(0, 1 << 32, shape, generator=g, device=device)
    return (hi << 32) | lo


def encrypt(enc: Encoding, big_key: torch.Tensor, values: torch.Tensor,
            g: torch.Generator) -> torch.Tensor:
    """Values [...] (0 <= v < 2 * msg * carry) -> LWE ciphertexts
    [..., k*N + 1] under the big key: body = <mask, s> + v * delta + e,
    e Gaussian of standard deviation glwe_std * 2^64, rounded."""
    dev = big_key.device
    shape = tuple(values.shape)
    rows = values.reshape(-1).to(device=dev, dtype=torch.int64)
    mask = uniform_words((rows.numel(), big_key.numel()), g, dev)
    noise = torch.round(torch.randn(rows.numel(), generator=g, device=dev,
                                    dtype=torch.float64)
                        * (enc.glwe_std * 2.0 ** TORUS_BITS))
    body = ((mask * big_key).sum(dim=-1) + (rows << enc.log_delta)
            + noise.to(torch.int64))
    return torch.cat([mask, body[:, None]], dim=-1).reshape(
        *shape, big_key.numel() + 1)


def phase(big_key: torch.Tensor, cts: torch.Tensor) -> torch.Tensor:
    """body - <mask, s> of ciphertexts [..., k*N + 1] (wrapping)."""
    key = big_key.to(cts.device)
    return cts[..., -1] - (cts[..., :-1] * key).sum(dim=-1)


def decode(enc: Encoding, ph: torch.Tensor):
    """Phases -> (values in [0, 2 * msg * carry): the padding bit, carry
    and message, rounded; |error| as a share of the decoding margin
    delta / 2)."""
    ld = enc.log_delta
    half = 1 << (ld - 1)
    values = ((ph + half) >> ld) & ((1 << (TORUS_BITS - ld)) - 1)
    err = ph - (values << ld)          # wraps into [-delta/2, delta/2)
    return values, err.abs().to(torch.float64) / half


def decrypt(enc: Encoding, big_key: torch.Tensor, cts: torch.Tensor,
            rows_per_block: int = 4096):
    """Decoded values and error shares of ciphertexts [R, k*N + 1], in
    blocks of rows so the products fit."""
    values, errs = [], []
    for lo in range(0, cts.shape[0], rows_per_block):
        v, e = decode(enc, phase(big_key, cts[lo:lo + rows_per_block]))
        values.append(v)
        errs.append(e)
    if not values:
        return (torch.zeros(0, dtype=torch.int64),
                torch.zeros(0, dtype=torch.float64))
    return torch.cat(values), torch.cat(errs)
