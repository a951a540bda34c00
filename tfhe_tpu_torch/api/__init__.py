"""High-level API (port of the first half of `tfhe_tpu/api/__init__.py`,
:1-486; ref: tfhe/src/high_level_api/).

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

The reference's second half (:487-791: the compressed, public and compact
types and the serialization adapters it registers at import) waits for the
port of the wire format and public keys (ROADMAP A.6): `PublicKey`,
`CompactPublicKey` and `CompressedServerKey` raise NotImplementedError, and
importing this module needs no serialization.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

from ..params import ClassicPBSParameters, PARAM_MESSAGE_2_CARRY_2_KS_PBS
from ..integer import (
    BooleanBlock,
    IntegerServerKey,
    RadixCiphertext,
    RadixClientKey,
)
from ..shortint import ServerKey as ShortintServerKey


@dataclass
class Config:
    parameters: ClassicPBSParameters


class ConfigBuilder:
    """(ref: high_level_api/config.rs)"""

    def __init__(self):
        self._params = PARAM_MESSAGE_2_CARRY_2_KS_PBS

    @staticmethod
    def default() -> "ConfigBuilder":
        return ConfigBuilder()

    def use_custom_parameters(self, params: ClassicPBSParameters) -> "ConfigBuilder":
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
                  fused: bool = False):
    """(ref: high_level_api/keys/mod.rs generate_keys) -> (ClientKey,
    ServerKey) on `device`.  The reference's `cache_dir` has no counterpart
    yet: the port writes no key to disk (ROADMAP A.6)."""
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


def _blocks_for_bits(params: ClassicPBSParameters, bits: int) -> int:
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

    def __and__(self, other: "FheBool") -> "FheBool":
        return FheBool(_server_key().boolean_bitand(self.inner, other.inner))

    def __or__(self, other: "FheBool") -> "FheBool":
        return FheBool(_server_key().boolean_bitor(self.inner, other.inner))

    def __xor__(self, other: "FheBool") -> "FheBool":
        return FheBool(_server_key().boolean_bitxor(self.inner, other.inner))

    def __invert__(self) -> "FheBool":
        return FheBool(_server_key().boolean_bitnot(self.inner))

    def _conformance_check(self, params) -> None:
        self.inner._conformance_check(params)

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

    def __add__(self, other):
        o, scalar = self._coerce(other)
        sk = _server_key()
        if scalar:
            return self._wrap(sk.scalar_add_parallelized(self.inner, o))
        return self._wrap(sk.add_parallelized(self.inner, o))

    __radd__ = __add__

    def __sub__(self, other):
        o, scalar = self._coerce(other)
        sk = _server_key()
        if scalar:
            return self._wrap(sk.scalar_sub_parallelized(self.inner, o))
        return self._wrap(sk.sub_parallelized(self.inner, o))

    def __mul__(self, other):
        o, scalar = self._coerce(other)
        sk = _server_key()
        if scalar:
            return self._wrap(sk.scalar_mul_parallelized(self.inner, o))
        return self._wrap(sk.mul_parallelized(self.inner, o))

    __rmul__ = __mul__

    def __neg__(self):
        return self._wrap(_server_key().neg_parallelized(self.inner))

    # -- bitwise --

    def _bitop(self, other, op):
        o, scalar = self._coerce(other)
        sk = _server_key()
        if scalar:
            o = sk.create_trivial_radix(o, self.inner.num_blocks)
        return self._wrap(getattr(sk, op)(self.inner, o))

    def __and__(self, other):
        return self._bitop(other, "bitand_parallelized")

    def __or__(self, other):
        return self._bitop(other, "bitor_parallelized")

    def __xor__(self, other):
        return self._bitop(other, "bitxor_parallelized")

    def __invert__(self):
        return self._wrap(_server_key().bitnot(self.inner))

    def __lshift__(self, shift):
        if isinstance(shift, _FheUintBase):
            return self._wrap(
                _server_key().left_shift_parallelized(self.inner, shift.inner))
        return self._wrap(
            _server_key().scalar_left_shift_parallelized(self.inner, shift))

    def __rshift__(self, shift):
        if isinstance(shift, _FheUintBase):
            return self._wrap(
                _server_key().right_shift_parallelized(self.inner, shift.inner))
        return self._wrap(
            _server_key().scalar_right_shift_parallelized(self.inner, shift))

    def rotate_left(self, rot):
        if isinstance(rot, _FheUintBase):
            return self._wrap(
                _server_key().rotate_left_parallelized(self.inner, rot.inner))
        return self._wrap(
            _server_key().scalar_rotate_left_parallelized(self.inner, rot))

    def rotate_right(self, rot):
        if isinstance(rot, _FheUintBase):
            return self._wrap(
                _server_key().rotate_right_parallelized(self.inner, rot.inner))
        return self._wrap(
            _server_key().scalar_rotate_right_parallelized(self.inner, rot))

    # -- division (ref: high_level_api Div/Rem impls; div by an encrypted
    # zero yields all-ones / the numerator like the reference) --

    def __floordiv__(self, other):
        o, scalar = self._coerce(other)
        sk = _server_key()
        if scalar:
            return self._wrap(sk.scalar_div_parallelized(self.inner, o))
        return self._wrap(sk.div_parallelized(self.inner, o))

    def __mod__(self, other):
        o, scalar = self._coerce(other)
        sk = _server_key()
        if scalar:
            return self._wrap(sk.scalar_rem_parallelized(self.inner, o))
        return self._wrap(sk.rem_parallelized(self.inner, o))

    def div_rem(self, other):
        o, scalar = self._coerce(other)
        sk = _server_key()
        if scalar:
            o = sk.create_trivial_radix(o, self.inner.num_blocks)
        q, r = sk.div_rem_parallelized(self.inner, o)
        return self._wrap(q), self._wrap(r)

    # -- overflow-reporting ops --

    def overflowing_add(self, other):
        o, scalar = self._coerce(other)
        sk = _server_key()
        if scalar:
            o = sk.create_trivial_radix(o, self.inner.num_blocks)
        s, ov = sk.overflowing_add_parallelized(self.inner, o)
        return self._wrap(s), FheBool(ov)

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

    def eq(self, other) -> FheBool:
        return self._cmp(other, "eq")

    def ne(self, other) -> FheBool:
        return self._cmp(other, "ne")

    def lt(self, other) -> FheBool:
        return self._cmp(other, "lt")

    def le(self, other) -> FheBool:
        return self._cmp(other, "le")

    def gt(self, other) -> FheBool:
        return self._cmp(other, "gt")

    def ge(self, other) -> FheBool:
        return self._cmp(other, "ge")

    __eq__ = eq  # type: ignore[assignment]
    __ne__ = ne  # type: ignore[assignment]
    __lt__ = lt
    __le__ = le
    __gt__ = gt
    __ge__ = ge
    __hash__ = None  # encrypted values are not hashable

    def max(self, other):
        o = other.inner if isinstance(other, _FheUintBase) else \
            _server_key().create_trivial_radix(other, self.inner.num_blocks)
        return self._wrap(_server_key().max_parallelized(self.inner, o))

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

    def abs(self) -> "_FheIntBase":
        return self._wrap(_server_key().abs_parallelized(self.inner))

    def __rshift__(self, shift):
        sk = _server_key()
        if isinstance(shift, _FheUintBase):
            return self._wrap(sk.signed_right_shift_parallelized(
                self.inner, shift.inner))
        return self._wrap(sk.signed_scalar_right_shift_parallelized(
            self.inner, shift))

    def __floordiv__(self, other):
        return self.div_rem(other)[0]

    def __mod__(self, other):
        return self.div_rem(other)[1]

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

    def eq(self, other) -> FheBool:
        return self._cmp(other, "eq")

    def ne(self, other) -> FheBool:
        return self._cmp(other, "ne")

    def lt(self, other) -> FheBool:
        return self._cmp(other, "lt")

    def le(self, other) -> FheBool:
        return self._cmp(other, "le")

    def gt(self, other) -> FheBool:
        return self._cmp(other, "gt")

    def ge(self, other) -> FheBool:
        return self._cmp(other, "ge")

    __eq__ = eq  # type: ignore[assignment]
    __ne__ = ne  # type: ignore[assignment]
    __lt__ = lt
    __le__ = le
    __gt__ = gt
    __ge__ = ge
    __hash__ = None

    def max(self, other):
        o = other.inner if isinstance(other, _FheUintBase) else \
            _server_key().create_trivial_radix(other, self.inner.num_blocks)
        return self._wrap(_server_key().signed_max_parallelized(self.inner, o))

    def min(self, other):
        o = other.inner if isinstance(other, _FheUintBase) else \
            _server_key().create_trivial_radix(other, self.inner.num_blocks)
        return self._wrap(_server_key().signed_min_parallelized(self.inner, o))

    def overflowing_add(self, other):
        o, scalar = self._coerce(other)
        sk = _server_key()
        if scalar:
            o = sk.create_trivial_radix(o, self.inner.num_blocks)
        s, ov = sk.signed_overflowing_add_parallelized(self.inner, o)
        return self._wrap(s), FheBool(ov)

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
# the reference's second half (tfhe_tpu/api/__init__.py:487-791) waits for
# ROADMAP A.6
# ---------------------------------------------------------------------------


def _needs_a6(what: str):
    raise NotImplementedError(
        f"the high-level {what} needs the port of the public keys, the "
        f"seeded keys and the wire format (ROADMAP A.6), which the port "
        f"does not have yet")


class CompressedServerKey:
    """(tfhe_tpu/api/__init__.py:493): not ported yet."""

    def __init__(self, cks: ClientKey):
        _needs_a6("CompressedServerKey")


class PublicKey:
    """(tfhe_tpu/api/__init__.py:584): not ported yet."""

    def __init__(self, cks: ClientKey):
        _needs_a6("PublicKey")


class CompactPublicKey:
    """(tfhe_tpu/api/__init__.py:598): not ported yet."""

    def __init__(self, cks: ClientKey):
        _needs_a6("CompactPublicKey")
