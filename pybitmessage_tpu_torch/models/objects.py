"""Bitmessage object header codec (copy of
``pybitmessage_tpu.models.objects``).

Every flooded object's payload is:

    u64  nonce        (the PoW)
    u64  expiresTime  (unix seconds)
    u32  objectType   (0 getpubkey / 1 pubkey / 2 msg / 3 broadcast)
    varint version
    varint stream
    ...  type-specific data

Reference parse: src/network/bmobject.py (checks: PoW, expiry sanity,
stream wanted, type-specific lengths) and src/network/bmproto.py:377-441.
"""

from __future__ import annotations

import struct
import time
from dataclasses import dataclass

from ..utils.varint import decode_varint
from .constants import (
    MAX_OBJECT_PAYLOAD_SIZE,
    MAX_TTL,
    MIN_TTL_SLACK,
    OBJECT_BROADCAST,
    OBJECT_GETPUBKEY,
    OBJECT_PUBKEY,
)


class ObjectError(ValueError):
    def __init__(self, kind: str, detail: str = ""):
        super().__init__(f"{kind}: {detail}" if detail else kind)
        self.kind = kind


@dataclass(frozen=True)
class ObjectHeader:
    nonce: int
    expires: int
    object_type: int
    version: int
    stream: int
    header_length: int  # bytes consumed, i.e. offset of type-specific data

    @classmethod
    def parse(cls, data: bytes) -> "ObjectHeader":
        if len(data) < 22:
            raise ObjectError("tooshort", f"{len(data)} bytes")
        if len(data) > MAX_OBJECT_PAYLOAD_SIZE:
            raise ObjectError("toolarge", f"{len(data)} bytes")
        nonce, expires, object_type = struct.unpack_from(">QQI", data)
        version, nver = decode_varint(data, 20)
        stream, nstream = decode_varint(data, 20 + nver)
        return cls(nonce, expires, object_type, version, stream,
                   20 + nver + nstream)

    def check_expiry(self, now: float | None = None) -> None:
        """Sanity bounds on expiresTime (reference: bmobject.py:46-49)."""
        now = time.time() if now is None else now
        if self.expires - now > MAX_TTL + 10800:
            raise ObjectError("expiretoofar")
        if now - self.expires > MIN_TTL_SLACK:
            raise ObjectError("expired")

def extract_tag(header: ObjectHeader, payload) -> bytes:
    """The 32-byte inventory routing tag, for object kinds that carry
    one: getpubkey/pubkey from v4, broadcast only from v5 (a v4
    broadcast's first 32 bytes are ciphertext, not a tag).  Accepts
    bytes or a memoryview; returns ``b""`` for untagged objects."""
    tagged = (header.object_type in (0, 1) and header.version >= 4) or \
             (header.object_type == 3 and header.version >= 5)
    if tagged and len(payload) >= header.header_length + 32:
        return bytes(
            payload[header.header_length:header.header_length + 32])
    return b""


def check_by_type(object_type: int, version: int, total_length: int) -> None:
    """Per-type sanity checks on the FULL object payload length
    (reference: bmobject.py:121-163).  Unknown types pass."""
    if object_type == OBJECT_GETPUBKEY and total_length < 42:
        raise ObjectError("invalidlength", "getpubkey too short")
    elif object_type == OBJECT_PUBKEY and not 146 <= total_length <= 440:
        raise ObjectError("invalidlength", "pubkey outside 146..440")
    elif object_type == OBJECT_BROADCAST:
        if total_length < 180:
            raise ObjectError("invalidlength", "broadcast too short")
        if version < 2:
            raise ObjectError("invalidversion", "broadcast v<2 unsupported")

