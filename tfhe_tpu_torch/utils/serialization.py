"""Versioned, size-limited, conformance-checked serialization.

Port of `tfhe_tpu/utils/serialization.py` (ref: tfhe/src/safe_
deserialization.rs:1-289 — magic/version header, a byte-size limit
enforced before allocation, and a parameter-conformance check after
decode; conformance trait at tfhe/src/conformance.rs:67).

Format (little-endian), the reference's byte for byte:
    8  bytes  magic  b"TFHETPU\\x01"
    u32       format version
    u32       type-name length, then UTF-8 type name
    u64       JSON metadata length, then metadata bytes
    u32       number of arrays; per array:
        u32 name len + name, u32 dtype len + dtype str,
        u32 ndim, u64 * ndim dims, then raw C-order bytes

The port carries torus words as int64 tensors; on the wire they are the
reference's "<u8" (and "<u4") words, under the reference's type names and
metadata, so one package's bytes load in the other.  Every serializable
class registers an adapter mapping object <-> (meta dict, numpy arrays);
deserializing puts tensors on `device` (the card unless the caller passes
"cpu").
"""

from __future__ import annotations

import dataclasses
import json
import struct
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.torus import to_numpy, to_tensor

MAGIC = b"TFHETPU\x01"
FORMAT_VERSION = 1

#: Default deserialization size limit (bytes), the reference's explicit
#: ``serialized_size_limit`` of safe_deserialize.
DEFAULT_LIMIT = 1 << 31


class DeserializationError(Exception):
    pass


class ConformanceError(DeserializationError):
    """Decoded object does not match the expected parameter set
    (ref: tfhe/src/conformance.rs ParameterSetConformant)."""


# ---------------------------------------------------------------------------
# adapter registry
# ---------------------------------------------------------------------------

ToState = Callable[[Any], Tuple[dict, Dict[str, np.ndarray]]]
FromState = Callable[[dict, Dict[str, np.ndarray], torch.device], Any]

_TO_STATE: Dict[type, ToState] = {}
_FROM_STATE: Dict[str, FromState] = {}
_TYPE_NAME: Dict[type, str] = {}


def register_adapter(cls: type, name: str, to_state: ToState,
                     from_state: FromState) -> None:
    """to_state(obj) -> (meta, numpy arrays); from_state(meta, arrays,
    device) -> obj."""
    _TO_STATE[cls] = to_state
    _FROM_STATE[name] = from_state
    _TYPE_NAME[cls] = name


def _find_adapter(obj: Any):
    for cls in type(obj).__mro__:
        if cls in _TO_STATE:
            return _TYPE_NAME[cls], _TO_STATE[cls]
    raise TypeError(f"no serialization adapter for {type(obj).__name__}")


def _words(t) -> np.ndarray:
    """u64 torus words of an int64 tensor (or a numpy array as it is)."""
    return to_numpy(t) if isinstance(t, torch.Tensor) else np.asarray(t)


# ---------------------------------------------------------------------------
# wire format
# ---------------------------------------------------------------------------


def _pack_str(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack("<I", len(b)) + b


def serialize(obj: Any) -> bytes:
    """Encode without a size limit (ref: plain bincode::serialize)."""
    name, to_state = _find_adapter(obj)
    meta, arrays = to_state(obj)
    meta_b = json.dumps(meta, sort_keys=True).encode("utf-8")
    out = [MAGIC, struct.pack("<I", FORMAT_VERSION), _pack_str(name),
           struct.pack("<Q", len(meta_b)), meta_b,
           struct.pack("<I", len(arrays))]
    for aname, arr in arrays.items():
        arr = np.ascontiguousarray(arr)
        out.append(_pack_str(aname))
        out.append(_pack_str(arr.dtype.str))
        out.append(struct.pack("<I", arr.ndim))
        out.append(struct.pack(f"<{arr.ndim}Q", *arr.shape))
        out.append(arr.tobytes())
    return b"".join(out)


class _Reader:
    def __init__(self, data: bytes, limit: int):
        if len(data) > limit:
            raise DeserializationError(
                f"serialized size {len(data)} exceeds limit {limit}")
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise DeserializationError("truncated input")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def string(self) -> str:
        return self.take(self.u32()).decode("utf-8")


def deserialize(data: bytes, limit: int = DEFAULT_LIMIT,
                device="cuda") -> Any:
    """Decode; tensors land on `device`."""
    device = resolve_device(device)
    r = _Reader(data, limit)
    if r.take(8) != MAGIC:
        raise DeserializationError("bad magic — not a tfhe_tpu payload")
    version = r.u32()
    if version != FORMAT_VERSION:
        raise DeserializationError(
            f"unsupported format version {version} (have {FORMAT_VERSION})")
    name = r.string()
    meta = json.loads(r.take(r.u64()).decode("utf-8"))
    arrays: Dict[str, np.ndarray] = {}
    for _ in range(r.u32()):
        aname = r.string()
        dtype = np.dtype(r.string())
        ndim = r.u32()
        shape = struct.unpack(f"<{ndim}Q", r.take(8 * ndim)) if ndim else ()
        nbytes = (int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
                  if shape else dtype.itemsize)
        arrays[aname] = np.frombuffer(r.take(nbytes),
                                      dtype=dtype).reshape(shape).copy()
    if name not in _FROM_STATE:
        raise DeserializationError(f"unknown serialized type {name!r}")
    return _FROM_STATE[name](meta, arrays, device)


def safe_serialize(obj: Any, limit: int = DEFAULT_LIMIT) -> bytes:
    """Serialize, refusing to emit more than `limit` bytes
    (ref: safe_deserialization.rs safe_serialize)."""
    data = serialize(obj)
    if len(data) > limit:
        raise DeserializationError(
            f"serialized size {len(data)} exceeds limit {limit}")
    return data


def safe_deserialize(data: bytes, expected_params=None,
                     limit: int = DEFAULT_LIMIT, device="cuda") -> Any:
    """Size-limited decode + parameter conformance check
    (ref: safe_deserialization.rs safe_deserialize_conformant)."""
    obj = deserialize(data, limit=limit, device=device)
    if expected_params is not None:
        check = getattr(obj, "_conformance_check", None)
        if check is not None:
            check(expected_params)
            return obj
        got = getattr(obj, "params", None)
        if got is None:
            got = getattr(getattr(obj, "inner", None), "params", None)
        if got is None:
            raise ConformanceError(
                f"{type(obj).__name__} carries no parameter information to "
                "check conformance against")
        if got != expected_params:
            raise ConformanceError(
                f"parameter mismatch: payload {getattr(got, 'name', got)!r} "
                f"!= expected "
                f"{getattr(expected_params, 'name', expected_params)!r}")
    return obj


# ---------------------------------------------------------------------------
# parameter-set adapters
# ---------------------------------------------------------------------------


def _params_to_meta(p) -> dict:
    d = dataclasses.asdict(p)
    if "encryption_key_choice" in d:
        d["encryption_key_choice"] = d["encryption_key_choice"].value
    d["__params_cls__"] = type(p).__name__
    return d


def _params_from_meta(d: dict):
    from ..params import types as ptypes

    d = dict(d)
    cls = getattr(ptypes, d.pop("__params_cls__"))
    if "encryption_key_choice" in d:
        d["encryption_key_choice"] = ptypes.EncryptionKeyChoice(
            d["encryption_key_choice"])
    return cls(**d)


def _register_all() -> None:
    from ..params.types import (BooleanParameters, ClassicPBSParameters,
                                MultiBitPBSParameters)
    from ..shortint.ciphertext import Ciphertext, ShortintBatch
    from ..integer.ciphertext import BooleanBlock, RadixCiphertext
    from ..integer.signed import SignedRadixCiphertext

    for pcls in (ClassicPBSParameters, MultiBitPBSParameters,
                 BooleanParameters):
        register_adapter(pcls, pcls.__name__,
                         lambda p: (_params_to_meta(p), {}),
                         lambda meta, arrays, dev: _params_from_meta(meta))

    register_adapter(
        Ciphertext, "shortint.Ciphertext",
        lambda c: (
            {"degree": c.degree, "message_modulus": c.message_modulus,
             "carry_modulus": c.carry_modulus, "noise_level": c.noise_level,
             "is_trivial": c.is_trivial},
            {"data": _words(c.data)}),
        lambda meta, arrays, dev: Ciphertext(
            data=to_tensor(arrays["data"], dev), **meta))

    def _batch_state(b):
        return (
            {"message_modulus": b.message_modulus,
             "carry_modulus": b.carry_modulus},
            {"data": _words(b.data), "degrees": np.asarray(b.degrees),
             "noise": np.asarray(b.noise)})

    def _batch_from(meta, arrays, dev):
        return ShortintBatch(data=to_tensor(arrays["data"], dev),
                             degrees=arrays["degrees"],
                             noise=arrays["noise"], **meta)

    register_adapter(ShortintBatch, "shortint.ShortintBatch", _batch_state,
                     _batch_from)

    def _radix_state(r):
        return _batch_state(r.blocks)

    def _radix_from(cls):
        return lambda meta, arrays, dev: cls(_batch_from(meta, arrays, dev))

    register_adapter(SignedRadixCiphertext, "integer.SignedRadixCiphertext",
                     _radix_state, _radix_from(SignedRadixCiphertext))
    register_adapter(RadixCiphertext, "integer.RadixCiphertext",
                     _radix_state, _radix_from(RadixCiphertext))
    register_adapter(BooleanBlock, "integer.BooleanBlock",
                     lambda b: _batch_state(b.block),
                     _radix_from(BooleanBlock))

    from ..integer.crt import CrtCiphertext

    register_adapter(
        CrtCiphertext, "integer.CrtCiphertext",
        lambda c: (
            {**_batch_state(c.blocks)[0], "moduli": list(map(int, c.moduli))},
            _batch_state(c.blocks)[1]),
        lambda meta, arrays, dev: CrtCiphertext(
            _batch_from({k: v for k, v in meta.items() if k != "moduli"},
                        arrays, dev),
            list(meta["moduli"])))

    # strings ----------------------------------------------------------
    from ..strings.ciphertext import FheAsciiChar, FheString, Padding

    def _concat_batches(batches):
        return ShortintBatch(
            data=torch.cat([b.data for b in batches]),
            degrees=np.concatenate([b.degrees for b in batches]),
            noise=np.concatenate([b.noise for b in batches]),
            message_modulus=batches[0].message_modulus,
            carry_modulus=batches[0].carry_modulus)

    def _fhestr_state(s):
        meta = {"padding": int(s.padding), "max_len": s.max_len}
        arrays = {}
        if s.content:
            stacked_meta, stacked = _batch_state(_concat_batches(
                [c.ct.blocks for c in s.content]))
            meta["blocks_meta"] = stacked_meta
            arrays.update({f"content_{k}": v for k, v in stacked.items()})
        if isinstance(s.length, int):
            meta["clear_length"] = s.length
        else:
            lmeta, larrs = _batch_state(s.length.blocks)
            meta["length_meta"] = lmeta
            arrays.update({f"length_{k}": v for k, v in larrs.items()})
        return meta, arrays

    def _prefixed(arrays, prefix):
        return {k[len(prefix):]: v for k, v in arrays.items()
                if k.startswith(prefix)}

    def _fhestr_from(meta, arrays, dev):
        content = []
        if "blocks_meta" in meta:
            stacked = _batch_from(meta["blocks_meta"],
                                  _prefixed(arrays, "content_"), dev)
            n = meta["max_len"]
            nb = len(stacked) // n
            for i in range(n):
                part = slice(i * nb, (i + 1) * nb)
                content.append(FheAsciiChar(RadixCiphertext(ShortintBatch(
                    data=stacked.data[part], degrees=stacked.degrees[part],
                    noise=stacked.noise[part],
                    message_modulus=stacked.message_modulus,
                    carry_modulus=stacked.carry_modulus))))
        if "clear_length" in meta:
            length = meta["clear_length"]
        else:
            length = RadixCiphertext(_batch_from(
                meta["length_meta"], _prefixed(arrays, "length_"), dev))
        return FheString(content=content, padding=Padding(meta["padding"]),
                         length=length)

    register_adapter(FheString, "strings.FheString", _fhestr_state,
                     _fhestr_from)
    register_adapter(
        FheAsciiChar, "strings.FheAsciiChar",
        lambda c: _batch_state(c.ct.blocks),
        lambda meta, arrays, dev: FheAsciiChar(
            RadixCiphertext(_batch_from(meta, arrays, dev))))

    # keys --------------------------------------------------------------
    from ..shortint.client_key import ClientKey as ShortintClientKey
    from ..shortint.server_key import ServerKey as ShortintServerKey

    register_adapter(
        ShortintClientKey, "shortint.ClientKey",
        lambda cks: (_params_to_meta(cks.params),
                     {"lwe_sk": _words(cks.lwe_sk.bits_array),
                      "glwe_sk": _words(cks.glwe_sk.bits_array)}),
        lambda meta, arrays, dev: ShortintClientKey.from_raw(
            _params_from_meta(meta), arrays["lwe_sk"], arrays["glwe_sk"],
            device=dev))

    register_adapter(
        ShortintServerKey, "shortint.ServerKey",
        lambda sks: (_params_to_meta(sks.params),
                     {"bsk": _words(sks.raw_bsk),
                      "ksk": _words(sks.raw_ksk)}),
        lambda meta, arrays, dev: ShortintServerKey.from_raw(
            _params_from_meta(meta), arrays["bsk"], arrays["ksk"],
            device=dev))

    # compressed (seeded) objects --------------------------------------
    from ..core.seeded import (SeededBootstrapKey, SeededKeyswitchKey,
                               SeededLweBatch)

    register_adapter(
        SeededLweBatch, "core.SeededLweBatch",
        lambda s: ({"mask_seed": str(s.mask_seed),
                    "lwe_dimension": s.lwe_dimension, "bits": s.bits},
                   {"bodies": _words(s.bodies)}),
        lambda meta, arrays, dev: SeededLweBatch(
            bodies=to_tensor(arrays["bodies"], dev),
            mask_seed=int(meta["mask_seed"]),
            lwe_dimension=meta["lwe_dimension"], bits=meta["bits"]))
    register_adapter(
        SeededBootstrapKey, "core.SeededBootstrapKey",
        lambda s: ({"mask_seed": str(s.mask_seed),
                    "glwe_dimension": s.glwe_dimension,
                    "base_log": s.base_log, "bits": s.bits},
                   {"bodies": _words(s.bodies)}),
        lambda meta, arrays, dev: SeededBootstrapKey(
            bodies=to_tensor(arrays["bodies"], dev),
            mask_seed=int(meta["mask_seed"]),
            glwe_dimension=meta["glwe_dimension"],
            base_log=meta["base_log"], bits=meta["bits"]))
    register_adapter(
        SeededKeyswitchKey, "core.SeededKeyswitchKey",
        lambda s: ({"mask_seed": str(s.mask_seed), "out_dim": s.out_dim,
                    "base_log": s.base_log, "bits": s.bits},
                   {"bodies": _words(s.bodies)}),
        lambda meta, arrays, dev: SeededKeyswitchKey(
            bodies=to_tensor(arrays["bodies"], dev),
            mask_seed=int(meta["mask_seed"]), out_dim=meta["out_dim"],
            base_log=meta["base_log"], bits=meta["bits"]))

    # public keys ------------------------------------------------------
    from ..core.public_key import (CompactLweCiphertextList,
                                   LweCompactPublicKey, LwePublicKey,
                                   SeededLweCompactPublicKey,
                                   SeededLwePublicKey)
    from ..shortint.public_key import (CompactCiphertextList,
                                       CompactPublicKey,
                                       CompressedCompactPublicKey,
                                       CompressedPublicKey, PublicKey)

    def _pk_from(meta, arrays, dev):
        self = PublicKey.__new__(PublicKey)
        self.params = _params_from_meta(meta)
        self.key = LwePublicKey(
            zero_encs=to_tensor(arrays["zero_encs"], dev),
            bits=self.params.torus_bits)
        return self

    register_adapter(
        PublicKey, "shortint.PublicKey",
        lambda pk: (_params_to_meta(pk.params),
                    {"zero_encs": _words(pk.key.zero_encs)}),
        _pk_from)

    def _cpk_from(meta, arrays, dev):
        self = CompactPublicKey.__new__(CompactPublicKey)
        self.params = _params_from_meta(meta)
        self.key = LweCompactPublicKey(
            mask=to_tensor(arrays["mask"], dev),
            body=to_tensor(arrays["body"], dev),
            bits=self.params.torus_bits)
        return self

    register_adapter(
        CompactPublicKey, "shortint.CompactPublicKey",
        lambda pk: (_params_to_meta(pk.params),
                    {"mask": _words(pk.key.mask),
                     "body": _words(pk.key.body)}),
        _cpk_from)

    def _comp_pk_from(meta, arrays, dev):
        self = CompressedPublicKey.__new__(CompressedPublicKey)
        self.params = _params_from_meta(meta["params"])
        self.seeded = SeededLwePublicKey(
            bodies=to_tensor(arrays["bodies"], dev),
            mask_seed=int(meta["mask_seed"]),
            lwe_dimension=meta["lwe_dimension"],
            bits=self.params.torus_bits)
        return self

    register_adapter(
        CompressedPublicKey, "shortint.CompressedPublicKey",
        lambda pk: ({"params": _params_to_meta(pk.params),
                     "mask_seed": str(pk.seeded.mask_seed),
                     "lwe_dimension": pk.seeded.lwe_dimension},
                    {"bodies": _words(pk.seeded.bodies)}),
        _comp_pk_from)

    def _comp_cpk_from(meta, arrays, dev):
        self = CompressedCompactPublicKey.__new__(CompressedCompactPublicKey)
        self.params = _params_from_meta(meta["params"])
        self.seeded = SeededLweCompactPublicKey(
            body=to_tensor(arrays["body"], dev),
            mask_seed=int(meta["mask_seed"]), bits=self.params.torus_bits)
        return self

    register_adapter(
        CompressedCompactPublicKey, "shortint.CompressedCompactPublicKey",
        lambda pk: ({"params": _params_to_meta(pk.params),
                     "mask_seed": str(pk.seeded.mask_seed)},
                    {"body": _words(pk.seeded.body)}),
        _comp_cpk_from)

    register_adapter(
        CompactCiphertextList, "shortint.CompactCiphertextList",
        lambda c: ({"message_modulus": c.message_modulus,
                    "carry_modulus": c.carry_modulus,
                    "bits": c.compact.bits},
                   {"masks": _words(c.compact.masks),
                    "bodies": _words(c.compact.bodies),
                    "degrees": np.asarray(c.degrees)}),
        lambda meta, arrays, dev: CompactCiphertextList(
            compact=CompactLweCiphertextList(
                masks=to_tensor(arrays["masks"], dev),
                bodies=to_tensor(arrays["bodies"], dev), bits=meta["bits"]),
            degrees=arrays["degrees"],
            message_modulus=meta["message_modulus"],
            carry_modulus=meta["carry_modulus"]))

    from ..shortint.compressed import (CompressedCiphertextList,
                                       CompressedServerKey)

    register_adapter(
        CompressedCiphertextList, "shortint.CompressedCiphertextList",
        lambda c: ({"mask_seed": str(c.seeded.mask_seed),
                    "lwe_dimension": c.seeded.lwe_dimension,
                    "bits": c.seeded.bits,
                    "message_modulus": c.message_modulus,
                    "carry_modulus": c.carry_modulus},
                   {"bodies": _words(c.seeded.bodies),
                    "degrees": np.asarray(c.degrees)}),
        lambda meta, arrays, dev: CompressedCiphertextList(
            seeded=SeededLweBatch(
                bodies=to_tensor(arrays["bodies"], dev),
                mask_seed=int(meta["mask_seed"]),
                lwe_dimension=meta["lwe_dimension"], bits=meta["bits"]),
            degrees=arrays["degrees"],
            message_modulus=meta["message_modulus"],
            carry_modulus=meta["carry_modulus"]))

    register_adapter(
        CompressedServerKey, "shortint.CompressedServerKey",
        lambda k: ({"params": _params_to_meta(k.params),
                    "bsk_mask_seed": str(k.seeded_bsk.mask_seed),
                    "ksk_mask_seed": str(k.seeded_ksk.mask_seed)},
                   {"bsk_bodies": _words(k.seeded_bsk.bodies),
                    "ksk_bodies": _words(k.seeded_ksk.bodies)}),
        CompressedServerKey._from_state)


_register_all()
