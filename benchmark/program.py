"""What every entry needs of the program under test (`tfhe_tpu_torch`):
its parameter set, checked against the configuration's numbers, and its
client key built on the secret keys the benchmark drew."""

from __future__ import annotations

import numpy as np


def parameters(cfg: dict):
    """The program's parameter set that the configuration names; raises
    unless every number the configuration states is the program's."""
    from tfhe_tpu_torch import params as program_params

    stated = cfg["parameters"]
    p = getattr(program_params, stated["name"])
    for key, value in stated.items():
        if key == "name":
            continue
        have = getattr(p, key)
        if key == "encryption_key_choice":
            have = have.name.lower()
        if have != value:
            raise ValueError(f"{stated['name']}.{key}: the program has "
                             f"{have!r}, the configuration states {value!r}")
    return p


def client_key(params, small, glwe, seed: int, device):
    """The program's shortint client key on the benchmark's secret key
    bits; its encryption randomness (which the server key's noise draws
    on) comes from the seed."""
    from tfhe_tpu_torch.shortint import ClientKey

    return ClientKey.from_raw(
        params, small.cpu().numpy().astype(np.uint64),
        glwe.cpu().numpy().astype(np.uint64), seed=seed, device=device)


def blocks(rows, degree: int, params):
    """Ciphertext rows [R, lwe_size] as the program's block batch, each
    block's degree `degree` (what a client states of a fresh block)."""
    from tfhe_tpu_torch.shortint.ciphertext import ShortintBatch

    return ShortintBatch(data=rows,
                         degrees=np.full(rows.shape[0], degree, np.int64),
                         message_modulus=params.message_modulus,
                         carry_modulus=params.carry_modulus)
