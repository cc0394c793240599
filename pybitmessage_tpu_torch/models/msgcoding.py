"""Message body encodings 1/2/3 (copy of
``pybitmessage_tpu.models.msgcoding``; reference: src/helper_msgcoding.py).

- 1 (trivial): raw body, no subject.
- 2 (simple):  b"Subject:<s>\nBody:<b>".
- 3 (extended): zlib-compressed msgpack map {"": "message", "subject": s,
  "body": b} with a decompression-bomb guard (reference caps the
  decompressed size, helper_msgcoding.py:99-117).
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass

try:
    import msgpack

    def _packb(obj):
        return msgpack.packb(obj, use_bin_type=False)

    def _unpackb(data):
        return msgpack.unpackb(data, raw=False, strict_map_key=False)
except ImportError:  # pragma: no cover - fallback codec
    msgpack = None

TRIVIAL = 1
SIMPLE = 2
EXTENDED = 3

#: decompression bomb guard (reference: zlib.decompressobj + 1 MiB cap,
#: default.ini extended-encoding maxsize)
MAX_EXTENDED_SIZE = 1024 * 1024


class DecodeError(ValueError):
    """Malformed message data."""


@dataclass
class MessageBody:
    subject: str
    body: str


def encode_message(subject: str, body: str, encoding: int = SIMPLE) -> bytes:
    if encoding == EXTENDED:
        if msgpack is None:
            raise DecodeError("msgpack unavailable for extended encoding")
        packed = _packb({"": "message", "subject": subject, "body": body})
        return zlib.compress(packed, 9)
    if encoding == SIMPLE:
        return b"Subject:" + subject.encode("utf-8") + b"\nBody:" + \
            body.encode("utf-8")
    if encoding == TRIVIAL:
        return body.encode("utf-8")
    raise DecodeError("unknown encoding %d" % encoding)


def decode_message(data: bytes, encoding: int) -> MessageBody:
    if encoding == EXTENDED:
        return _decode_extended(data)
    if encoding == SIMPLE:
        # Reference semantics (helper_msgcoding.py decodeSimple): find
        # "\nBody:"; if present past index 1, subject = bytes 8..idx
        # (blind "Subject:" strip), first line only, capped at 500 chars
        # ("any more is probably an attack"); otherwise the whole data
        # is the body with an empty subject.
        idx = data.find(b"\nBody:")
        if idx > 1:
            subject = data[8:idx]
            subject = subject.splitlines()[0] if subject else b""
            body = data[idx + 6:]
        else:
            subject, body = b"", data
        return MessageBody(
            subject.decode("utf-8", "replace")[:500],
            body.decode("utf-8", "replace"))
    if encoding == TRIVIAL:
        return MessageBody("", data.decode("utf-8", "replace"))
    raise DecodeError("unknown encoding %d" % encoding)


def _decode_extended(data: bytes) -> MessageBody:
    if msgpack is None:
        raise DecodeError("msgpack unavailable for extended encoding")
    dec = zlib.decompressobj()
    out = dec.decompress(data, MAX_EXTENDED_SIZE)
    if dec.unconsumed_tail:
        raise DecodeError("extended message exceeds decompression cap")
    try:
        obj = _unpackb(out)
    except Exception as exc:
        raise DecodeError("bad msgpack payload") from exc
    # dispatch through the extended-type registry (whitelisted types
    # only — reference messagetypes/constructObject)
    from .messagetypes import MessageTypeError, construct
    try:
        mt = construct(obj)
    except MessageTypeError as exc:
        raise DecodeError(str(exc)) from exc
    return MessageBody(mt.data.get("subject", ""), mt.data.get("body", ""))
