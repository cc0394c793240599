"""Bitmessage protocol varint codec (copy of
``pybitmessage_tpu.utils.varint``).

Wire format (big-endian, Bitcoin-style "CompactSize" with BE integers):

    value < 0xfd               -> 1 byte
    value <= 0xffff            -> 0xfd + u16
    value <= 0xffffffff        -> 0xfe + u32
    value <= 0xffffffffffffffff-> 0xff + u64

Protocol v3 requires *minimal* encodings on decode: a value that could have
been encoded in a shorter form is malformed (reference:
src/addresses.py:82-134).
"""

from __future__ import annotations

import struct


class VarintError(ValueError):
    """Raised on a malformed or out-of-range varint."""


_U16 = struct.Struct(">H")
_U32 = struct.Struct(">I")
_U64 = struct.Struct(">Q")


def encode_varint(value: int) -> bytes:
    if value < 0:
        raise VarintError("varint cannot be negative")
    if value < 0xFD:
        return bytes((value,))
    if value <= 0xFFFF:
        return b"\xfd" + _U16.pack(value)
    if value <= 0xFFFFFFFF:
        return b"\xfe" + _U32.pack(value)
    if value <= 0xFFFFFFFFFFFFFFFF:
        return b"\xff" + _U64.pack(value)
    raise VarintError("varint cannot exceed 2**64 - 1")


def decode_varint(data: bytes, offset: int = 0) -> tuple[int, int]:
    """Decode a varint at ``data[offset:]``.

    Returns ``(value, nbytes_consumed)``.  Enforces minimal encoding and
    sufficient length, raising :class:`VarintError` otherwise.  An empty
    input decodes to ``(0, 0)`` for parity with the reference decoder
    (src/addresses.py:93-94).
    """
    view = memoryview(data)[offset:]
    if len(view) == 0:
        return 0, 0
    first = view[0]
    if first < 0xFD:
        return first, 1
    if first == 0xFD:
        if len(view) < 3:
            raise VarintError("truncated 3-byte varint")
        value = _U16.unpack_from(view, 1)[0]
        if value < 0xFD:
            raise VarintError("non-minimal varint encoding")
        return value, 3
    if first == 0xFE:
        if len(view) < 5:
            raise VarintError("truncated 5-byte varint")
        value = _U32.unpack_from(view, 1)[0]
        if value <= 0xFFFF:
            raise VarintError("non-minimal varint encoding")
        return value, 5
    if len(view) < 9:
        raise VarintError("truncated 9-byte varint")
    value = _U64.unpack_from(view, 1)[0]
    if value <= 0xFFFFFFFF:
        raise VarintError("non-minimal varint encoding")
    return value, 9


def decode_varint_list(data: bytes, count: int, offset: int = 0) -> tuple[list[int], int]:
    """Decode ``count`` consecutive varints; returns (values, total_bytes)."""
    values = []
    pos = offset
    for _ in range(count):
        value, used = decode_varint(data, pos)
        if used == 0:
            raise VarintError("ran out of data decoding varint list")
        values.append(value)
        pos += used
    return values, pos - offset
