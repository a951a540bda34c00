"""Samplers over the CSPRNG byte stream (copy of `tfhe_tpu/prng/sampling.py`).

Reproduces the reference's distributions and byte-consumption conventions:
  * uniform torus values read Scalar::BITS/8 little-endian bytes per value
    (ref: tfhe/src/core_crypto/commons/math/random/uniform.rs);
  * uniform binary reads ONE byte per bit, keeping the lsb
    (ref: .../random/uniform_binary.rs);
  * gaussian pairs use the polar Box-Muller rejection loop over 16-byte
    records (8 bytes u, 8 bytes v, both i64 LE scaled by 2^-63), accepting
    when 0 < s=u^2+v^2 < 1 (ref: .../random/gaussian.rs:17-49);
  * torus conversion rounds the centered fraction onto the 2^bits grid
    (ref: .../math/torus/mod.rs FromTorus).
"""

from __future__ import annotations

import numpy as np

from .stream import AesCtrStream


def uniform_torus(stream: AesCtrStream, n: int, bits: int = 64) -> np.ndarray:
    nbytes = bits // 8
    raw = stream.next_bytes(n * nbytes)
    if bits == 128:
        # u128 as little-endian (lo, hi) uint64 pairs [n, 2]
        return raw.view(np.uint64).reshape(n, 2).copy()
    dtype = np.uint64 if bits == 64 else np.uint32
    return raw.view(dtype).copy()  # little-endian platform


def uniform_binary(stream: AesCtrStream, n: int) -> np.ndarray:
    """n bits, one stream byte each (lsb)."""
    raw = stream.next_bytes(n)
    return (raw & 1).astype(np.uint64)


def f64_from_torus(x: np.ndarray, bits: int = 64) -> np.ndarray:
    """Round a float torus value (mod 1) onto the 2^bits integer grid."""
    frac = x - np.round(x)  # centered fraction in [-0.5, 0.5]
    scaled = np.round(frac * float(2.0 ** bits))
    # |scaled| <= 2^(bits-1); guard the exact edge to avoid signed overflow
    limit = float(2.0 ** (bits - 1))
    scaled = np.where(scaled >= limit, scaled - float(2.0 ** bits), scaled)
    if bits == 128:
        # exact split of the f64 value (<= 53 significant bits) into
        # two's-complement (lo, hi) uint64 pairs [n, 2]
        hi_f = np.floor(scaled / float(2.0 ** 64))
        lo_f = scaled - hi_f * float(2.0 ** 64)  # in [0, 2^64), exact
        hi = hi_f.astype(np.int64).astype(np.uint64)
        lo = lo_f.astype(np.uint64)
        return np.stack([lo, hi], axis=-1)
    dtype = np.uint64 if bits == 64 else np.uint32
    return scaled.astype(np.int64).astype(dtype)


def gaussian_pairs(stream: AesCtrStream, n_pairs: int, std: float,
                   mean: float = 0.0) -> np.ndarray:
    """n_pairs polar Box-Muller pairs -> flat f64 array of 2*n_pairs values."""
    out = np.empty(2 * n_pairs, dtype=np.float64)
    filled = 0
    scale = 2.0 ** -63
    while filled < 2 * n_pairs:
        need = n_pairs - filled // 2
        # acceptance prob is pi/4 ~ 0.785; draw a margin of records, then
        # rewind the stream past the last record actually consumed so the
        # byte-consumption matches the reference's one-record-at-a-time loop.
        batch = max(16, int(need * 1.4) + 8)
        rem = stream.remaining_bytes() // 16
        batch = min(batch, rem)
        if batch <= 0:
            raise RuntimeError("noise stream exhausted during gaussian sampling")
        pos_before = stream.current
        raw = stream.next_bytes(batch * 16).view(np.int64).reshape(batch, 2)
        u = raw[:, 0].astype(np.float64) * scale
        v = raw[:, 1].astype(np.float64) * scale
        s = u * u + v * v
        ok = (s > 0.0) & (s < 1.0)
        n_ok = int(np.count_nonzero(ok))
        take = min(n_ok, need)
        if take < n_ok:
            # index (in records) of the `take`-th acceptance
            last_rec = int(np.nonzero(np.cumsum(ok) == take)[0][0])
            stream.current = pos_before + (last_rec + 1) * 16
        u, v, s = u[ok][:take], v[ok][:take], s[ok][:take]
        if take > 0:
            cst = std * np.sqrt(-2.0 * np.log(s) / s)
            pair_block = np.empty(2 * take, dtype=np.float64)
            pair_block[0::2] = u * cst + mean
            pair_block[1::2] = v * cst + mean
            out[filled:filled + 2 * take] = pair_block
            filled += 2 * take
    return out


def gaussian_noise_torus(stream: AesCtrStream, n: int, std: float,
                         bits: int = 64) -> np.ndarray:
    """n gaussian torus values; pairwise fill, odd tail keeps the first of a
    pair (ref: fill_slice semantics, chunks of 2)."""
    if std == 0.0:
        # Degenerate distribution — still consume no bytes (matches x*0=0
        # through the sampler, but skip the rejection loop entirely for speed).
        if bits == 128:
            return np.zeros((n, 2), dtype=np.uint64)
        return np.zeros(n, dtype=np.uint64 if bits == 64 else np.uint32)
    n_pairs = (n + 1) // 2
    vals = gaussian_pairs(stream, n_pairs, std)
    return f64_from_torus(vals[:n], bits=bits)
