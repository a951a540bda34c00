"""Keys carried across from the JAX package.

The reference keeps key material as numpy arrays (`ServerKey.raw_bsk` /
`raw_ksk`, `ClientKey.lwe_sk.bits_array` / `glwe_sk.bits_array`; its
high-level keys hold them in `ClientKey.radix.key` and
`ServerKey.integer_key.key`); its boolean `ServerKey` keeps no raw keys, so
those come from its `core.generate_bootstrap_key` /
`generate_keyswitch_key`, and its u128 bootstrap key from
`core.generate_bootstrap_key_u128`; its `WopbsKey` holds the pfpksk list
as `cbs.pfpksk_list`.  These
functions turn such arrays into the port's keys, so both packages can
compute on the same keys.  They take plain numpy arrays and import nothing
from the JAX package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from . import api, boolean
from .integer import IntegerServerKey, RadixClientKey
from .ops.polymul_ntt import PreparedBskNtt, prepare_bsk_ntt
from .params import (BooleanParameters, ClassicPBSParameters,
                     MultiBitPBSParameters, WopbsParameters)
from .shortint import ClientKey, ServerKey, WopbsKey


def server_key_from_reference(
        params: ClassicPBSParameters | MultiBitPBSParameters, raw_bsk, raw_ksk,
        device="cuda", mode: Optional[str] = None) -> ServerKey:
    """raw_bsk and raw_ksk (the reference's `ServerKey.raw_bsk` /
    `raw_ksk`, its `from_raw` inputs, server_key.py:103-108), in either PBS
    order: raw_bsk is [n, L, G, G, N] for classic parameters and
    [n/gf, 2^gf, L, G, G, N] for multi-bit ones; raw_ksk, from the big key
    to the small one, is [k*N, ks_level, n+1].  The server key's blind
    rotation runs in schedule `mode` (None: the key kind's default; "ntt",
    for classic and multi-bit keys, prepares the CRT-NTT layout)."""
    gf = getattr(params, "grouping_factor", None)
    G, N = params.glwe_size, params.polynomial_size
    n, L = params.lwe_dimension, params.pbs_level
    want_bsk = ((n, L, G, G, N) if gf is None
                else (n // gf, 1 << gf, L, G, G, N))
    want_ksk = (params.big_lwe_dimension, params.ks_level, n + 1)
    for name, key, want in (("BSK", raw_bsk, want_bsk),
                            ("KSK", raw_ksk, want_ksk)):
        if tuple(key.shape) != want:
            raise ValueError(f"{params.name}: raw {name} of shape "
                             f"{tuple(key.shape)}, expected {want}")
    return ServerKey.from_raw(params, raw_bsk, raw_ksk, device=device,
                              mode=mode)


def client_key_from_reference(
        params: ClassicPBSParameters | MultiBitPBSParameters, lwe_sk_bits,
        glwe_sk_bits, seed: Optional[int] = None,
        device="cuda") -> ClientKey:
    """Secret-key bits [n] and [k, N] (the reference's
    `ClientKey.from_raw` inputs, client_key.py:30)."""
    return ClientKey.from_raw(params, lwe_sk_bits, glwe_sk_bits, seed=seed,
                              device=device)


def api_keys_from_reference(
        config: api.Config, lwe_sk_bits, glwe_sk_bits, raw_bsk, raw_ksk,
        seed: Optional[int] = None, device="cuda",
        fused: bool = False) -> tuple[api.ClientKey, api.ServerKey]:
    """The high-level API's (ClientKey, ServerKey) from the reference's
    high-level keys' arrays (`cks.radix.key.lwe_sk.bits_array`,
    `...glwe_sk.bits_array`, `sks.integer_key.key.raw_bsk`, `...raw_ksk`),
    at `config.parameters`: the client key through
    `client_key_from_reference` (`seed` seeds its encryptions), the server
    key through `server_key_from_reference`, in the radix schedule `fused`
    names."""
    p = config.parameters
    key = client_key_from_reference(p, lwe_sk_bits, glwe_sk_bits, seed=seed,
                                    device=device)
    cks = api.ClientKey(config, _radix=RadixClientKey(p, 1, _key=key))
    isk = IntegerServerKey(
        server_key_from_reference(p, raw_bsk, raw_ksk, device=device),
        fused=fused)
    return cks, api.ServerKey(cks, _integer_key=isk)


def boolean_client_key_from_reference(
        params: BooleanParameters, lwe_sk_bits, glwe_sk_bits,
        seed: Optional[int] = None, device="cuda") -> boolean.ClientKey:
    """Secret-key bits [n] and [k, N] of a boolean client key."""
    n, k, N = (params.lwe_dimension, params.glwe_dimension,
               params.polynomial_size)
    for name, bits, want in (("LWE key", lwe_sk_bits, (n,)),
                             ("GLWE key", glwe_sk_bits, (k, N))):
        if tuple(bits.shape) != want:
            raise ValueError(f"{params.name}: {name} of shape "
                             f"{tuple(bits.shape)}, expected {want}")
    return boolean.ClientKey.from_raw(params, lwe_sk_bits, glwe_sk_bits,
                                      seed=seed, device=device)


def boolean_server_key_from_reference(
        params: BooleanParameters, raw_bsk, raw_ksk, device="cuda",
        mode: str = "scan2") -> boolean.ServerKey:
    """raw_bsk [n, L, G, G, N] and raw_ksk [k*N, ks_level, n+1] uint32 (the
    reference's standard-domain boolean keys)."""
    G, N = params.glwe_size, params.polynomial_size
    n, L = params.lwe_dimension, params.pbs_level
    for name, key, want in (
            ("BSK", raw_bsk, (n, L, G, G, N)),
            ("KSK", raw_ksk, (params.big_lwe_dimension, params.ks_level,
                              n + 1))):
        if tuple(key.shape) != want:
            raise ValueError(f"{params.name}: raw {name} of shape "
                             f"{tuple(key.shape)}, expected {want}")
    return boolean.ServerKey.from_raw(params, raw_bsk, raw_ksk, device=device,
                                      mode=mode)


def bootstrap_key_u128_from_reference(
        raw_bsk, base_log: int, lwe_dimension: int, glwe_dimension: int,
        polynomial_size: int, levels: int, device="cuda") -> PreparedBskNtt:
    """The reference's u128 bootstrap key (`core.generate_bootstrap_key_
    u128`: numpy uint64 [n, L, G, G, N, 2], (lo, hi) pairs) -> the port's
    CRT-NTT key at 128 bits, after a check of its type and shape."""
    G = glwe_dimension + 1
    want = (lwe_dimension, levels, G, G, polynomial_size, 2)
    if raw_bsk.dtype != np.uint64 or tuple(raw_bsk.shape) != want:
        raise ValueError(f"u128 BSK of {raw_bsk.dtype} {tuple(raw_bsk.shape)}"
                         f", expected uint64 {want}")
    return prepare_bsk_ntt(raw_bsk, base_log, bits=128, device=device)


def wopbs_key_from_reference(
        params: WopbsParameters, raw_bsk, raw_ksk, pfpksk, device="cuda",
        mode: Optional[str] = None) -> WopbsKey:
    """The port's WopbsKey from the reference's raw arrays: its server
    key's `raw_bsk` [n, L, G, G, N] and `raw_ksk` [k*N, ks_level, n+1], and
    its WoPBS key's `cbs.pfpksk_list` [G, k*N+1, pfks_level, G, N], after a
    check of the pfpksk's shape; the server key's blind rotation in
    schedule `mode` (None: "scan2")."""
    G, N = params.glwe_size, params.polynomial_size
    want = (G, params.big_lwe_dimension + 1, params.pfks_level, G, N)
    if tuple(pfpksk.shape) != want:
        raise ValueError(f"{params.name}: pfpksk of shape "
                         f"{tuple(pfpksk.shape)}, expected {want}")
    sks = server_key_from_reference(params, raw_bsk, raw_ksk, device=device,
                                    mode=mode)
    return WopbsKey.from_raw(params, sks, np.asarray(pfpksk, np.uint64))
