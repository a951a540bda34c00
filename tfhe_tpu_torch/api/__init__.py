"""High-level API (port of `tfhe_tpu/api/__init__.py`; ref: tfhe/src/
high_level_api/).

ConfigBuilder -> generate_keys(config) -> set_server_key(sk) ->
operator-overloaded FheUint8..FheUint256 / FheInt8..FheInt256 / FheBool
(ref: high_level_api/mod.rs:37-49; global server key state ref:
high_level_api/global_state.rs:13-104 — here a thread-local of this
module's own).  Every operator is one radix op of `integer.
IntegerServerKey`, so its blocks are the reference's word for word.

Keys live on `device` (the card unless the caller passes "cpu"); `fused`
picks the radix schedule (`IntegerServerKey(fused=)`: False the host
schedule, True one CUDA graph replay an op on a card, the counterpart of
the reference's choice on its accelerator, tfhe_tpu/integer/
fused_dispatch.py:35-41).  No environment variable picks either.
Every public operator, and `if_then_else`, is a span `api.<op>`
(`utils.profiling.spanned`): recorded while a torch.profiler session runs,
a flag check otherwise.

The second half (:487-791) too: the compressed, public and compact types,
and the serialization adapters, registered at import under the
reference's type names (registering loads no key and builds no kernel).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..params import (ClassicPBSParameters, MultiBitPBSParameters,
                      PARAM_MESSAGE_2_CARRY_2_KS_PBS)
from ..integer import (
    BooleanBlock,
    IntegerServerKey,
    RadixCiphertext,
    RadixClientKey,
    SignedRadixCiphertext,
    gen_keys_radix,
)
from ..shortint import ServerKey as ShortintServerKey
from ..utils.profiling import spanned


@dataclass
class Config:
    """The keys' shortint parameter set: classic, whose server key runs the
    classic PBS, or multi-bit, whose server key runs the multi-bit PBS
    (`shortint.ServerKey`); every type and operator takes either."""

    parameters: ClassicPBSParameters | MultiBitPBSParameters


class ConfigBuilder:
    """(ref: high_level_api/config.rs)"""

    def __init__(self):
        self._params = PARAM_MESSAGE_2_CARRY_2_KS_PBS

    @staticmethod
    def default() -> "ConfigBuilder":
        return ConfigBuilder()

    def use_custom_parameters(
            self, params: ClassicPBSParameters | MultiBitPBSParameters
    ) -> "ConfigBuilder":
        """A classic or a multi-bit parameter set in place of the default
        `PARAM_MESSAGE_2_CARRY_2_KS_PBS` (ref: config.rs
        use_custom_parameters, which takes either PBS kind)."""
        self._params = params
        return self

    def build(self) -> Config:
        return Config(parameters=self._params)


class ClientKey:
    """A radix client key on `device` (the card unless the caller passes
    "cpu"); the block count is chosen per type at encryption."""

    def __init__(self, config: Config, seed: Optional[int] = None,
                 device="cuda", _radix: Optional[RadixClientKey] = None):
        self.config = config
        self._radix = _radix if _radix is not None else RadixClientKey(
            config.parameters, num_blocks=1, seed=seed, device=device)

    @property
    def radix(self) -> RadixClientKey:
        return self._radix


class ServerKey:
    """The radix server key of a client key, on its device, in the radix
    schedule `fused` names."""

    def __init__(self, cks: ClientKey, fused: bool = False,
                 _integer_key: Optional[IntegerServerKey] = None):
        self.integer_key = (_integer_key if _integer_key is not None
                            else IntegerServerKey(
                                ShortintServerKey(cks.radix.key),
                                fused=fused))


def generate_keys(config: Config, seed: Optional[int] = None, device="cuda",
                  fused: bool = False, cache_dir: Optional[str] = None):
    """(ref: high_level_api/keys/mod.rs generate_keys) -> (ClientKey,
    ServerKey) on `device`; with `cache_dir` and a seed the raw keys ride
    the shortint key cache (`shortint.gen_keys(cache_dir=)`)."""
    if cache_dir is not None and seed is not None:
        r_cks, i_sks = gen_keys_radix(config.parameters, num_blocks=1,
                                      seed=seed, device=device,
                                      cache_dir=cache_dir)
        cks = ClientKey(config, _radix=r_cks)
        return cks, ServerKey(cks, _integer_key=IntegerServerKey(
            i_sks.key, fused=fused))
    cks = ClientKey(config, seed=seed, device=device)
    return cks, ServerKey(cks, fused=fused)


_state = threading.local()


def set_server_key(sk: ServerKey) -> None:
    _state.server_key = sk


def _server_key() -> IntegerServerKey:
    sk = getattr(_state, "server_key", None)
    if sk is None:
        raise RuntimeError("no server key set; call set_server_key(sk) first")
    return sk.integer_key


def _blocks_for_bits(params: ClassicPBSParameters | MultiBitPBSParameters,
                     bits: int) -> int:
    """Radix blocks of a `bits`-bit integer: the message bits a block holds
    depend on the set's message modulus alone, whatever its PBS kind."""
    bpb = params.message_modulus.bit_length() - 1
    return -(-bits // bpb)


class FheBool:
    def __init__(self, inner: BooleanBlock):
        self.inner = inner

    @classmethod
    def encrypt(cls, value: bool, key: ClientKey) -> "FheBool":
        return cls(key.radix.encrypt_bool(bool(value)))

    @classmethod
    def encrypt_trivial(cls, value: bool) -> "FheBool":
        return cls(_server_key().create_trivial_bool(bool(value)))

    def decrypt(self, key: ClientKey) -> bool:
        return key.radix.decrypt_bool(self.inner)

    @spanned("api.bitand")
    def __and__(self, other: "FheBool") -> "FheBool":
        return FheBool(_server_key().boolean_bitand(self.inner, other.inner))

    @spanned("api.bitor")
    def __or__(self, other: "FheBool") -> "FheBool":
        return FheBool(_server_key().boolean_bitor(self.inner, other.inner))

    @spanned("api.bitxor")
    def __xor__(self, other: "FheBool") -> "FheBool":
        return FheBool(_server_key().boolean_bitxor(self.inner, other.inner))

    @spanned("api.bitnot")
    def __invert__(self) -> "FheBool":
        return FheBool(_server_key().boolean_bitnot(self.inner))

    def _conformance_check(self, params) -> None:
        self.inner._conformance_check(params)

    @spanned("api.if_then_else")
    def if_then_else(self, then_v: "_FheUintBase", else_v: "_FheUintBase"):
        out = _server_key().if_then_else_parallelized(
            self.inner, then_v.inner, else_v.inner
        )
        return type(then_v)(out)


class _FheUintBase:
    """Shared implementation of the FheUintN types
    (ref: high_level_api/integers/types/base.rs)."""

    NUM_BITS: int = 0

    def __init__(self, inner: RadixCiphertext):
        self.inner = inner

    def _conformance_check(self, params) -> None:
        self.inner._conformance_check(params)

    # -- construction --

    @classmethod
    def encrypt(cls, value: int, key: ClientKey) -> "_FheUintBase":
        nb = _blocks_for_bits(key.config.parameters, cls.NUM_BITS)
        return cls(key.radix.encrypt(value, num_blocks=nb))

    @classmethod
    def encrypt_trivial(cls, value: int) -> "_FheUintBase":
        sk = _server_key()
        nb = _blocks_for_bits(sk.key.params, cls.NUM_BITS)
        return cls(sk.create_trivial_radix(value, nb))

    def decrypt(self, key: ClientKey) -> int:
        return key.radix.decrypt(self.inner)

    @spanned("api.cast_into")
    def cast_into(self, target_cls):
        """Width/signedness cast, e.g. FheUint32 -> FheUint16 truncates and
        FheInt8 -> FheInt32 sign-extends (ref: high_level_api
        CastFrom/CastInto impls over integer cast_to_{un,}signed)."""
        sk = _server_key()
        nb = _blocks_for_bits(sk.key.params, target_cls.NUM_BITS)
        if issubclass(target_cls, _FheIntBase):
            return target_cls(sk.cast_to_signed(self.inner, nb))
        return target_cls(sk.cast_to_unsigned(self.inner, nb))

    # -- arithmetic --

    def _wrap(self, ct: RadixCiphertext):
        return type(self)(ct)

    def _coerce(self, other):
        if isinstance(other, _FheUintBase):
            return other.inner, False
        if isinstance(other, int):
            return other, True
        return NotImplemented, None

    @spanned("api.add")
    def __add__(self, other):
        o, scalar = self._coerce(other)
        sk = _server_key()
        if scalar:
            return self._wrap(sk.scalar_add_parallelized(self.inner, o))
        return self._wrap(sk.add_parallelized(self.inner, o))

    __radd__ = __add__

    @spanned("api.sub")
    def __sub__(self, other):
        o, scalar = self._coerce(other)
        sk = _server_key()
        if scalar:
            return self._wrap(sk.scalar_sub_parallelized(self.inner, o))
        return self._wrap(sk.sub_parallelized(self.inner, o))

    @spanned("api.mul")
    def __mul__(self, other):
        o, scalar = self._coerce(other)
        sk = _server_key()
        if scalar:
            return self._wrap(sk.scalar_mul_parallelized(self.inner, o))
        return self._wrap(sk.mul_parallelized(self.inner, o))

    __rmul__ = __mul__

    @spanned("api.neg")
    def __neg__(self):
        return self._wrap(_server_key().neg_parallelized(self.inner))

    # -- bitwise --

    def _bitop(self, other, op):
        o, scalar = self._coerce(other)
        sk = _server_key()
        if scalar:
            o = sk.create_trivial_radix(o, self.inner.num_blocks)
        return self._wrap(getattr(sk, op)(self.inner, o))

    @spanned("api.bitand")
    def __and__(self, other):
        return self._bitop(other, "bitand_parallelized")

    @spanned("api.bitor")
    def __or__(self, other):
        return self._bitop(other, "bitor_parallelized")

    @spanned("api.bitxor")
    def __xor__(self, other):
        return self._bitop(other, "bitxor_parallelized")

    @spanned("api.bitnot")
    def __invert__(self):
        return self._wrap(_server_key().bitnot(self.inner))

    @spanned("api.shl")
    def __lshift__(self, shift):
        if isinstance(shift, _FheUintBase):
            return self._wrap(
                _server_key().left_shift_parallelized(self.inner, shift.inner))
        return self._wrap(
            _server_key().scalar_left_shift_parallelized(self.inner, shift))

    @spanned("api.shr")
    def __rshift__(self, shift):
        if isinstance(shift, _FheUintBase):
            return self._wrap(
                _server_key().right_shift_parallelized(self.inner, shift.inner))
        return self._wrap(
            _server_key().scalar_right_shift_parallelized(self.inner, shift))

    @spanned("api.rotate_left")
    def rotate_left(self, rot):
        if isinstance(rot, _FheUintBase):
            return self._wrap(
                _server_key().rotate_left_parallelized(self.inner, rot.inner))
        return self._wrap(
            _server_key().scalar_rotate_left_parallelized(self.inner, rot))

    @spanned("api.rotate_right")
    def rotate_right(self, rot):
        if isinstance(rot, _FheUintBase):
            return self._wrap(
                _server_key().rotate_right_parallelized(self.inner, rot.inner))
        return self._wrap(
            _server_key().scalar_rotate_right_parallelized(self.inner, rot))

    # -- division (ref: high_level_api Div/Rem impls; div by an encrypted
    # zero yields all-ones / the numerator like the reference) --

    @spanned("api.div")
    def __floordiv__(self, other):
        o, scalar = self._coerce(other)
        sk = _server_key()
        if scalar:
            return self._wrap(sk.scalar_div_parallelized(self.inner, o))
        return self._wrap(sk.div_parallelized(self.inner, o))

    @spanned("api.rem")
    def __mod__(self, other):
        o, scalar = self._coerce(other)
        sk = _server_key()
        if scalar:
            return self._wrap(sk.scalar_rem_parallelized(self.inner, o))
        return self._wrap(sk.rem_parallelized(self.inner, o))

    @spanned("api.div_rem")
    def div_rem(self, other):
        o, scalar = self._coerce(other)
        sk = _server_key()
        if scalar:
            o = sk.create_trivial_radix(o, self.inner.num_blocks)
        q, r = sk.div_rem_parallelized(self.inner, o)
        return self._wrap(q), self._wrap(r)

    # -- overflow-reporting ops --

    @spanned("api.overflowing_add")
    def overflowing_add(self, other):
        o, scalar = self._coerce(other)
        sk = _server_key()
        if scalar:
            o = sk.create_trivial_radix(o, self.inner.num_blocks)
        s, ov = sk.overflowing_add_parallelized(self.inner, o)
        return self._wrap(s), FheBool(ov)

    @spanned("api.overflowing_sub")
    def overflowing_sub(self, other):
        o, scalar = self._coerce(other)
        sk = _server_key()
        if scalar:
            o = sk.create_trivial_radix(o, self.inner.num_blocks)
        s, ov = sk.overflowing_sub_parallelized(self.inner, o)
        return self._wrap(s), FheBool(ov)

    # -- comparisons (return FheBool, like the reference's FheOrd) --

    def _cmp(self, other, op) -> FheBool:
        sk = _server_key()
        if isinstance(other, int):
            other = sk.create_trivial_radix(other, self.inner.num_blocks)
        else:
            other = other.inner
        return FheBool(getattr(sk, f"{op}_parallelized")(self.inner, other))

    @spanned("api.eq")
    def eq(self, other) -> FheBool:
        return self._cmp(other, "eq")

    @spanned("api.ne")
    def ne(self, other) -> FheBool:
        return self._cmp(other, "ne")

    @spanned("api.lt")
    def lt(self, other) -> FheBool:
        return self._cmp(other, "lt")

    @spanned("api.le")
    def le(self, other) -> FheBool:
        return self._cmp(other, "le")

    @spanned("api.gt")
    def gt(self, other) -> FheBool:
        return self._cmp(other, "gt")

    @spanned("api.ge")
    def ge(self, other) -> FheBool:
        return self._cmp(other, "ge")

    __eq__ = eq  # type: ignore[assignment]
    __ne__ = ne  # type: ignore[assignment]
    __lt__ = lt
    __le__ = le
    __gt__ = gt
    __ge__ = ge
    __hash__ = None  # encrypted values are not hashable

    @spanned("api.max")
    def max(self, other):
        o = other.inner if isinstance(other, _FheUintBase) else \
            _server_key().create_trivial_radix(other, self.inner.num_blocks)
        return self._wrap(_server_key().max_parallelized(self.inner, o))

    @spanned("api.min")
    def min(self, other):
        o = other.inner if isinstance(other, _FheUintBase) else \
            _server_key().create_trivial_radix(other, self.inner.num_blocks)
        return self._wrap(_server_key().min_parallelized(self.inner, o))


class _FheIntBase(_FheUintBase):
    """Shared implementation of the FheIntN types: two's complement over
    the same radix blocks (ref: high_level_api/integers/types/base.rs
    FheInt expansion; integer signed ops ref: integer/server_key/
    radix_parallel/{abs,comparison,shift,div_mod}.rs signed variants)."""

    @classmethod
    def encrypt(cls, value: int, key: ClientKey) -> "_FheIntBase":
        nb = _blocks_for_bits(key.config.parameters, cls.NUM_BITS)
        return cls(key.radix.encrypt_signed(value, num_blocks=nb))

    def decrypt(self, key: ClientKey) -> int:
        return key.radix.decrypt_signed(self.inner)

    # -- sign-aware ops --

    @spanned("api.abs")
    def abs(self) -> "_FheIntBase":
        return self._wrap(_server_key().abs_parallelized(self.inner))

    @spanned("api.shr")
    def __rshift__(self, shift):
        sk = _server_key()
        if isinstance(shift, _FheUintBase):
            return self._wrap(sk.signed_right_shift_parallelized(
                self.inner, shift.inner))
        return self._wrap(sk.signed_scalar_right_shift_parallelized(
            self.inner, shift))

    @spanned("api.div")
    def __floordiv__(self, other):
        return self.div_rem(other)[0]

    @spanned("api.rem")
    def __mod__(self, other):
        return self.div_rem(other)[1]

    @spanned("api.div_rem")
    def div_rem(self, other):
        """Truncating division like Rust (not Python floor division)."""
        o, scalar = self._coerce(other)
        sk = _server_key()
        if scalar:
            q, r = sk.signed_scalar_div_rem_parallelized(self.inner, o)
        else:
            q, r = sk.signed_div_rem_parallelized(self.inner, o)
        return self._wrap(q), self._wrap(r)

    def _cmp(self, other, op) -> FheBool:
        sk = _server_key()
        if isinstance(other, int):
            return FheBool(sk.signed_scalar_cmp_parallelized(
                self.inner, other, op))
        return FheBool(sk.signed_cmp_parallelized(self.inner, other.inner, op))

    @spanned("api.eq")
    def eq(self, other) -> FheBool:
        return self._cmp(other, "eq")

    @spanned("api.ne")
    def ne(self, other) -> FheBool:
        return self._cmp(other, "ne")

    @spanned("api.lt")
    def lt(self, other) -> FheBool:
        return self._cmp(other, "lt")

    @spanned("api.le")
    def le(self, other) -> FheBool:
        return self._cmp(other, "le")

    @spanned("api.gt")
    def gt(self, other) -> FheBool:
        return self._cmp(other, "gt")

    @spanned("api.ge")
    def ge(self, other) -> FheBool:
        return self._cmp(other, "ge")

    __eq__ = eq  # type: ignore[assignment]
    __ne__ = ne  # type: ignore[assignment]
    __lt__ = lt
    __le__ = le
    __gt__ = gt
    __ge__ = ge
    __hash__ = None

    @spanned("api.max")
    def max(self, other):
        o = other.inner if isinstance(other, _FheUintBase) else \
            _server_key().create_trivial_radix(other, self.inner.num_blocks)
        return self._wrap(_server_key().signed_max_parallelized(self.inner, o))

    @spanned("api.min")
    def min(self, other):
        o = other.inner if isinstance(other, _FheUintBase) else \
            _server_key().create_trivial_radix(other, self.inner.num_blocks)
        return self._wrap(_server_key().signed_min_parallelized(self.inner, o))

    @spanned("api.overflowing_add")
    def overflowing_add(self, other):
        o, scalar = self._coerce(other)
        sk = _server_key()
        if scalar:
            o = sk.create_trivial_radix(o, self.inner.num_blocks)
        s, ov = sk.signed_overflowing_add_parallelized(self.inner, o)
        return self._wrap(s), FheBool(ov)

    @spanned("api.overflowing_sub")
    def overflowing_sub(self, other):
        o, scalar = self._coerce(other)
        sk = _server_key()
        if scalar:
            o = sk.create_trivial_radix(o, self.inner.num_blocks)
        s, ov = sk.signed_overflowing_sub_parallelized(self.inner, o)
        return self._wrap(s), FheBool(ov)


def _make_fheuint(bits: int):
    cls = type(f"FheUint{bits}", (_FheUintBase,), {"NUM_BITS": bits})
    return cls


def _make_fheint(bits: int):
    cls = type(f"FheInt{bits}", (_FheIntBase,), {"NUM_BITS": bits})
    return cls


FheUint8 = _make_fheuint(8)
FheUint16 = _make_fheuint(16)
FheUint32 = _make_fheuint(32)
FheUint64 = _make_fheuint(64)
FheUint128 = _make_fheuint(128)
FheUint256 = _make_fheuint(256)

FheInt8 = _make_fheint(8)
FheInt16 = _make_fheint(16)
FheInt32 = _make_fheint(32)
FheInt64 = _make_fheint(64)
FheInt128 = _make_fheint(128)
FheInt256 = _make_fheint(256)


# ---------------------------------------------------------------------------
# compressed types (ref: high_level_api/integers/types/compressed.rs and
# high_level_api/keys/server.rs CompressedServerKey)
# ---------------------------------------------------------------------------


class CompressedServerKey:
    """Seeded server key: about half the bytes on the wire; decompressed on
    the server, onto the device its bodies are on
    (ref: high_level_api/keys/server.rs CompressedServerKey)."""

    def __init__(self, cks: ClientKey):
        from ..shortint import CompressedServerKey as ShortintCompressed

        self.inner = ShortintCompressed(cks.radix.key)

    @classmethod
    def _wrap(cls, inner) -> "CompressedServerKey":
        self = cls.__new__(cls)
        self.inner = inner
        return self

    @property
    def params(self):
        return self.inner.params

    def decompress(self) -> ServerKey:
        return ServerKey(None, _integer_key=IntegerServerKey(
            self.inner.decompress()))


class _CompressedFheBase:
    """A compressed (seeded) fresh encryption of one FheUint/FheInt value:
    the blocks' bodies + the public mask seed
    (ref: high_level_api/integers/types/compressed.rs CompressedFheUint)."""

    FHE_CLS = None

    def __init__(self, compressed_list, signed: bool):
        self.compressed_list = compressed_list
        self.signed = signed

    def _conformance_check(self, params) -> None:
        self.compressed_list._conformance_check(params)

    @classmethod
    def encrypt(cls, value: int, key: ClientKey):
        from ..shortint import encrypt_compressed_batch

        rck = key.radix
        nb = _blocks_for_bits(key.config.parameters, cls.FHE_CLS.NUM_BITS)
        comp = encrypt_compressed_batch(rck.key, rck._to_blocks(value, nb))
        return cls(comp, signed=issubclass(cls.FHE_CLS, _FheIntBase))

    def decompress(self):
        batch = self.compressed_list.decompress()
        if self.signed:
            return self.FHE_CLS(SignedRadixCiphertext(batch))
        return self.FHE_CLS(RadixCiphertext(batch))


def _make_compressed(fhe_cls):
    return type(f"Compressed{fhe_cls.__name__}", (_CompressedFheBase,),
                {"FHE_CLS": fhe_cls})


CompressedFheUint8 = _make_compressed(FheUint8)
CompressedFheUint16 = _make_compressed(FheUint16)
CompressedFheUint32 = _make_compressed(FheUint32)
CompressedFheUint64 = _make_compressed(FheUint64)
CompressedFheUint128 = _make_compressed(FheUint128)
CompressedFheUint256 = _make_compressed(FheUint256)
CompressedFheInt8 = _make_compressed(FheInt8)
CompressedFheInt16 = _make_compressed(FheInt16)
CompressedFheInt32 = _make_compressed(FheInt32)
CompressedFheInt64 = _make_compressed(FheInt64)
CompressedFheInt128 = _make_compressed(FheInt128)
CompressedFheInt256 = _make_compressed(FheInt256)


# ---------------------------------------------------------------------------
# public keys (ref: high_level_api/keys/public.rs PublicKey/CompactPublicKey
# and integers/types/compact.rs CompactFheUint)
# ---------------------------------------------------------------------------


def _value_blocks(params, value: int, num_blocks: int) -> np.ndarray:
    msg = params.message_modulus
    value %= msg ** num_blocks
    return np.array([(value // msg**i) % msg for i in range(num_blocks)],
                    dtype=np.uint64)


class PublicKey:
    """Standard public key, on the client key's device: anyone holding it
    can encrypt (ref: high_level_api/keys/public.rs)."""

    def __init__(self, cks: ClientKey):
        from ..shortint.public_key import PublicKey as ShortintPublicKey

        self.inner = ShortintPublicKey(cks.radix.key)

    @property
    def params(self):
        return self.inner.params


class CompactPublicKey:
    """Compact public key: the ciphertext lists it makes stay packed until
    `expand()` (ref: high_level_api/keys/public.rs CompactPublicKey)."""

    def __init__(self, cks: ClientKey):
        from ..shortint.public_key import (
            CompactPublicKey as ShortintCompactPublicKey)

        self.inner = ShortintCompactPublicKey(cks.radix.key)

    @property
    def params(self):
        return self.inner.params


class _CompactFheBase:
    """Compact fresh encryption of one value under a CompactPublicKey
    (ref: high_level_api/integers/types/compact.rs CompactFheUint)."""

    FHE_CLS = None

    def __init__(self, compact_list):
        self.compact_list = compact_list

    @classmethod
    def encrypt(cls, value: int, key: CompactPublicKey):
        p = key.params
        nb = _blocks_for_bits(p, cls.FHE_CLS.NUM_BITS)
        return cls(key.inner.encrypt_compact_batch(_value_blocks(p, value,
                                                                 nb)))

    def expand(self):
        batch = self.compact_list.expand()
        if issubclass(self.FHE_CLS, _FheIntBase):
            return self.FHE_CLS(SignedRadixCiphertext(batch))
        return self.FHE_CLS(RadixCiphertext(batch))

    def _conformance_check(self, params) -> None:
        self.compact_list._conformance_check(params)


def _make_compact(fhe_cls):
    return type(f"Compact{fhe_cls.__name__}", (_CompactFheBase,),
                {"FHE_CLS": fhe_cls})


CompactFheUint8 = _make_compact(FheUint8)
CompactFheUint16 = _make_compact(FheUint16)
CompactFheUint32 = _make_compact(FheUint32)
CompactFheUint64 = _make_compact(FheUint64)
CompactFheUint128 = _make_compact(FheUint128)
CompactFheUint256 = _make_compact(FheUint256)
CompactFheInt8 = _make_compact(FheInt8)
CompactFheInt16 = _make_compact(FheInt16)
CompactFheInt32 = _make_compact(FheInt32)
CompactFheInt64 = _make_compact(FheInt64)
CompactFheInt128 = _make_compact(FheInt128)
CompactFheInt256 = _make_compact(FheInt256)


def _encrypt_with_public_key(cls, value: int, key: PublicKey):
    p = key.params
    nb = _blocks_for_bits(p, cls.NUM_BITS)
    batch = key.inner.encrypt_batch(_value_blocks(p, value, nb))
    if issubclass(cls, _FheIntBase):
        return cls(SignedRadixCiphertext(batch))
    return cls(RadixCiphertext(batch))


_FheUintBase.encrypt_with_public_key = classmethod(_encrypt_with_public_key)


# ---------------------------------------------------------------------------
# serialization adapters for the high-level types
# (ref: serde derives on the high_level_api types + safe_deserialization.rs)
# ---------------------------------------------------------------------------


def _register_hl_adapters():
    """Registered at import, under the reference's type names; registering
    loads no key and builds no kernel."""
    import sys

    from ..utils import serialization as ser

    mod = sys.modules[__name__]

    def _fhe_state(obj):
        inner_meta, arrays = ser._TO_STATE[type(obj.inner)](obj.inner)
        return {"fhe_cls": type(obj).__name__, "inner": inner_meta}, arrays

    def _fhe_from(meta, arrays, dev):
        cls = getattr(mod, meta["fhe_cls"])
        if issubclass(cls, _FheIntBase):
            name = "integer.SignedRadixCiphertext"
        elif issubclass(cls, _FheUintBase):
            name = "integer.RadixCiphertext"
        else:
            name = "integer.BooleanBlock"
        return cls(ser._FROM_STATE[name](meta["inner"], arrays, dev))

    ser.register_adapter(_FheUintBase, "api.FheUint", _fhe_state, _fhe_from)
    ser.register_adapter(FheBool, "api.FheBool", _fhe_state, _fhe_from)

    def _comp_state(obj):
        meta, arrays = ser._TO_STATE[type(obj.compressed_list)](
            obj.compressed_list)
        return {"fhe_cls": type(obj).__name__, "inner": meta}, arrays

    def _comp_from(meta, arrays, dev):
        cls = getattr(mod, meta["fhe_cls"])
        inner = ser._FROM_STATE["shortint.CompressedCiphertextList"](
            meta["inner"], arrays, dev)
        return cls(inner, signed=issubclass(cls.FHE_CLS, _FheIntBase))

    ser.register_adapter(_CompressedFheBase, "api.CompressedFhe",
                         _comp_state, _comp_from)

    def _sks_state(obj):
        return ser._TO_STATE[type(obj.integer_key.key)](obj.integer_key.key)

    def _sks_from(meta, arrays, dev):
        return ServerKey(None, _integer_key=IntegerServerKey(
            ser._FROM_STATE["shortint.ServerKey"](meta, arrays, dev)))

    ser.register_adapter(ServerKey, "api.ServerKey", _sks_state, _sks_from)

    ser.register_adapter(
        CompressedServerKey, "api.CompressedServerKey",
        lambda obj: ser._TO_STATE[type(obj.inner)](obj.inner),
        lambda meta, arrays, dev: CompressedServerKey._wrap(
            ser._FROM_STATE["shortint.CompressedServerKey"](meta, arrays,
                                                            dev)))

    def _cks_state(obj):
        meta, arrays = ser._TO_STATE[type(obj.radix.key)](obj.radix.key)
        return {"inner": meta}, arrays

    def _cks_from(meta, arrays, dev):
        skey = ser._FROM_STATE["shortint.ClientKey"](meta["inner"], arrays,
                                                     dev)
        return ClientKey(Config(parameters=skey.params),
                         _radix=RadixClientKey(skey.params, 1, _key=skey))

    ser.register_adapter(ClientKey, "api.ClientKey", _cks_state, _cks_from)

    def _pk_state(obj):
        return ser._TO_STATE[type(obj.inner)](obj.inner)

    def _wrap_pk(cls, name):
        def from_state(meta, arrays, dev):
            self = cls.__new__(cls)
            self.inner = ser._FROM_STATE[name](meta, arrays, dev)
            return self

        return from_state

    ser.register_adapter(PublicKey, "api.PublicKey", _pk_state,
                         _wrap_pk(PublicKey, "shortint.PublicKey"))
    ser.register_adapter(CompactPublicKey, "api.CompactPublicKey", _pk_state,
                         _wrap_pk(CompactPublicKey,
                                  "shortint.CompactPublicKey"))

    def _compact_fhe_state(obj):
        meta, arrays = ser._TO_STATE[type(obj.compact_list)](
            obj.compact_list)
        return {"fhe_cls": type(obj).__name__, "inner": meta}, arrays

    def _compact_fhe_from(meta, arrays, dev):
        cls = getattr(mod, meta["fhe_cls"])
        return cls(ser._FROM_STATE["shortint.CompactCiphertextList"](
            meta["inner"], arrays, dev))

    ser.register_adapter(_CompactFheBase, "api.CompactFhe",
                         _compact_fhe_state, _compact_fhe_from)


_register_hl_adapters()


__all__ = [
    "Config",
    "ConfigBuilder",
    "ClientKey",
    "ServerKey",
    "generate_keys",
    "set_server_key",
    "CompressedServerKey",
    "PublicKey",
    "CompactPublicKey",
    "CompactFheUint8",
    "CompactFheUint16",
    "CompactFheUint32",
    "CompactFheUint64",
    "CompactFheUint128",
    "CompactFheUint256",
    "CompactFheInt8",
    "CompactFheInt16",
    "CompactFheInt32",
    "CompactFheInt64",
    "CompactFheInt128",
    "CompactFheInt256",
    "CompressedFheUint8",
    "CompressedFheUint16",
    "CompressedFheUint32",
    "CompressedFheUint64",
    "CompressedFheUint128",
    "CompressedFheUint256",
    "CompressedFheInt8",
    "CompressedFheInt16",
    "CompressedFheInt32",
    "CompressedFheInt64",
    "CompressedFheInt128",
    "CompressedFheInt256",
    "FheBool",
    "FheUint8",
    "FheUint16",
    "FheUint32",
    "FheUint64",
    "FheUint128",
    "FheUint256",
    "FheInt8",
    "FheInt16",
    "FheInt32",
    "FheInt64",
    "FheInt128",
    "FheInt256",
]
