"""Length-prefixed local IPC between node roles (copy of
``pybitmessage_tpu.roles.ipc``: its frames byte for byte, both ways).

The role-split deployment (edge processes + stream-sharded relays)
hands objects between processes over this channel.  One frame per
message with a fixed 8-byte header::

    magic(2) = 0xE1 0x44 | version(1) | type(1) | payload_len(u32 BE)

Everything is big-endian.  Eleven message kinds carry the cross-role
contract:

``HELLO`` (edge -> relay) / ``HELLO_ACK`` (relay -> edge)
    Role name, node id, the sender's streams and its shard-map epoch.
    The ACK is how an edge learns a relay's shard (``rolestreams``).
``OBJECTS`` (edge -> relay) / ``OBJECTS_ACK`` (relay -> edge)
    One batch of accepted objects (hash, type, stream, expires, tag,
    payload each) under one monotonic frame ``seq``, and its frame-level
    acknowledgement with accepted/duplicate/rejected counts.  The edge
    holds every un-acked frame and re-sends it after a reconnect; the
    relay dedupes by inventory hash.
``INV`` (relay -> edge)
    (stream, expires, hash) triples the relay just accepted.
``OBJECT_PUSH`` (relay -> edge)
    One full object record: relay-originated objects and ``FETCH``
    replies, so edges serve ``getdata`` for objects they never ingested.
``FETCH`` (edge -> relay)
    Request one payload by hash.
``PING``/``PONG``
    Liveness probe; its round trip feeds the replica health ladder.
``SHARD_UPDATE`` (relay -> edge)
    The relay's shard map changed mid-session: new epoch and streams.
    An edge applies it only when the epoch is newer than the one it
    holds.
``HANDOFF`` (relay -> relay)
    ``begin``/``end``/``ack`` control frames bracketing a live shard
    handoff; the records travel as ordinary acked ``OBJECTS`` frames.

``HELLO``/``HELLO_ACK`` and ``SHARD_UPDATE`` carry a shard-map epoch
(u64); a ``HELLO`` without it decodes with epoch 0.  The edge's frame
sends and the relay's ack and push sends are planted with the
``role.ipc`` chaos site, the handoff's sends with ``role.handoff``.
"""

from __future__ import annotations

import struct

from ..observability import REGISTRY

MAGIC = b"\xe1\x44"
VERSION = 1
HEADER = struct.Struct(">2sBBI")
HEADER_LEN = HEADER.size

#: hard frame ceiling — an OBJECTS batch of a few hundred max-size
#: objects; anything larger is a broken peer, not a bigger batch
MAX_FRAME = 32 << 20

MSG_HELLO = 1
MSG_HELLO_ACK = 2
MSG_OBJECTS = 3
MSG_OBJECTS_ACK = 4
MSG_INV = 5
MSG_OBJECT_PUSH = 6
MSG_FETCH = 7
MSG_PING = 8
MSG_PONG = 9
MSG_SHARD_UPDATE = 10
MSG_HANDOFF = 11

#: HANDOFF frame kinds
HANDOFF_BEGIN = 0
HANDOFF_END = 1
HANDOFF_ACK = 2

#: bounded label vocabulary for the frame counter
FRAME_NAMES = {
    MSG_HELLO: "hello", MSG_HELLO_ACK: "hello_ack",
    MSG_OBJECTS: "objects", MSG_OBJECTS_ACK: "objects_ack",
    MSG_INV: "inv", MSG_OBJECT_PUSH: "object_push",
    MSG_FETCH: "fetch", MSG_PING: "ping", MSG_PONG: "pong",
    MSG_SHARD_UPDATE: "shard_update", MSG_HANDOFF: "handoff",
}

FRAMES = REGISTRY.counter(
    "role_ipc_frames_total",
    "Cross-role IPC frames by type and direction",
    ("type", "direction"))
IPC_BYTES = REGISTRY.counter(
    "role_ipc_bytes_total",
    "Cross-role IPC payload bytes by direction", ("direction",))


class IPCError(ValueError):
    """Malformed role-IPC frame or payload."""


def pack_frame(msg_type: int, payload: bytes) -> bytes:
    if len(payload) > MAX_FRAME:
        raise IPCError("frame payload %d > %d" % (len(payload), MAX_FRAME))
    FRAMES.labels(type=FRAME_NAMES.get(msg_type, "hello"),
                  direction="tx").inc()
    IPC_BYTES.labels(direction="tx").inc(HEADER_LEN + len(payload))
    return HEADER.pack(MAGIC, VERSION, msg_type, len(payload)) + payload


def parse_header(data: bytes) -> tuple[int, int]:
    """-> (msg_type, payload_len); raises on bad magic/version/size."""
    magic, version, msg_type, length = HEADER.unpack(data)
    if magic != MAGIC:
        raise IPCError("bad role-ipc frame magic %r" % magic)
    if version != VERSION:
        raise IPCError("unsupported role-ipc version %d" % version)
    if length > MAX_FRAME:
        raise IPCError("frame payload %d > %d" % (length, MAX_FRAME))
    return msg_type, length


async def read_frame(reader) -> tuple[int, bytes]:
    """Read one frame from an asyncio StreamReader."""
    header = await reader.readexactly(HEADER_LEN)
    msg_type, length = parse_header(header)
    payload = await reader.readexactly(length) if length else b""
    FRAMES.labels(type=FRAME_NAMES.get(msg_type, "hello"),
                  direction="rx").inc()
    IPC_BYTES.labels(direction="rx").inc(HEADER_LEN + length)
    return msg_type, payload


# -- field helpers ------------------------------------------------------------

def _pack_str(value: str | bytes, limit: int = 255) -> bytes:
    raw = value.encode("utf-8") if isinstance(value, str) else bytes(value)
    if len(raw) > limit:
        raise IPCError("field too long (%d > %d)" % (len(raw), limit))
    return bytes((len(raw),)) + raw


def _unpack_str(data: bytes, offset: int) -> tuple[bytes, int]:
    if offset >= len(data):
        raise IPCError("truncated role-ipc payload")
    n = data[offset]
    end = offset + 1 + n
    if end > len(data):
        raise IPCError("truncated role-ipc payload")
    return data[offset + 1:end], end


# -- messages -----------------------------------------------------------------

def encode_hello(role: str, node_id: str, streams: tuple[int, ...],
                 epoch: int = 0) -> bytes:
    out = _pack_str(role, 16) + _pack_str(node_id, 64)
    out += struct.pack(">H", len(streams))
    for s in streams:
        out += struct.pack(">I", s)
    out += struct.pack(">Q", epoch)
    return out


def decode_hello(data: bytes) -> tuple[str, str, tuple[int, ...], int]:
    """-> (role, node_id, streams, epoch).  The trailing shard-map
    epoch is optional on the wire (pre-epoch binaries omit it) and
    defaults to 0."""
    role, off = _unpack_str(data, 0)
    node_id, off = _unpack_str(data, off)
    try:
        (n,) = struct.unpack_from(">H", data, off)
        streams = struct.unpack_from(">%dI" % n, data, off + 2)
    except struct.error as exc:
        raise IPCError("truncated hello: %s" % exc)
    off += 2 + 4 * n
    epoch = 0
    if len(data) >= off + 8:
        (epoch,) = struct.unpack_from(">Q", data, off)
    return (role.decode("utf-8", "replace"),
            node_id.decode("utf-8", "replace"), tuple(streams), epoch)


#: one object record inside OBJECTS / OBJECT_PUSH:
#: hash(32) type(u32) stream(u32) expires(q) taglen(u8)+tag paylen(u32)
_REC_FIXED = struct.Struct(">32sIIq")


def encode_record(h: bytes, type_: int, stream: int, expires: int,
                  tag: bytes, payload: bytes) -> bytes:
    return (_REC_FIXED.pack(h, type_, stream, expires)
            + _pack_str(tag, 64)
            + struct.pack(">I", len(payload)) + payload)


def decode_record(data: bytes, offset: int = 0):
    """-> ((hash, type, stream, expires, tag, payload), next_offset)."""
    try:
        h, type_, stream, expires = _REC_FIXED.unpack_from(data, offset)
    except struct.error as exc:
        raise IPCError("truncated record: %s" % exc)
    tag, off = _unpack_str(data, offset + _REC_FIXED.size)
    try:
        (plen,) = struct.unpack_from(">I", data, off)
    except struct.error as exc:
        raise IPCError("truncated record: %s" % exc)
    end = off + 4 + plen
    if end > len(data):
        raise IPCError("truncated record payload")
    return (h, type_, stream, expires, bytes(tag),
            bytes(data[off + 4:end])), end


def record_stream(record: bytes) -> int:
    """The stream number of one encoded record blob (no full decode —
    used to re-route un-acked records after a relay's shard changed)."""
    try:
        (stream,) = struct.unpack_from(">I", record, 36)
        return stream
    except struct.error:
        raise IPCError("truncated record")


def encode_objects(seq: int, records: list[bytes]) -> bytes:
    """``records`` are pre-encoded :func:`encode_record` blobs."""
    return (struct.pack(">QI", seq, len(records))
            + b"".join(records))


def decode_objects(data: bytes):
    """-> (seq, [record tuples])."""
    try:
        seq, count = struct.unpack_from(">QI", data, 0)
    except struct.error as exc:
        raise IPCError("truncated objects frame: %s" % exc)
    off, records = 12, []
    for _ in range(count):
        rec, off = decode_record(data, off)
        records.append(rec)
    return seq, records


_ACK = struct.Struct(">QIII")


def encode_objects_ack(seq: int, accepted: int, duplicate: int,
                       rejected: int) -> bytes:
    return _ACK.pack(seq, accepted, duplicate, rejected)


def decode_objects_ack(data: bytes) -> tuple[int, int, int, int]:
    try:
        return _ACK.unpack_from(data, 0)
    except struct.error as exc:
        raise IPCError("truncated objects ack: %s" % exc)


_INV_ENTRY = struct.Struct(">Iq32s")


def encode_inv(entries: list[tuple[int, int, bytes]]) -> bytes:
    """``entries`` = [(stream, expires, hash)]."""
    return (struct.pack(">I", len(entries))
            + b"".join(_INV_ENTRY.pack(s, e, h) for s, e, h in entries))


def decode_inv(data: bytes) -> list[tuple[int, int, bytes]]:
    try:
        (n,) = struct.unpack_from(">I", data, 0)
        return [_INV_ENTRY.unpack_from(data, 4 + i * _INV_ENTRY.size)
                for i in range(n)]
    except struct.error as exc:
        raise IPCError("truncated inv frame: %s" % exc)


def encode_fetch(h: bytes) -> bytes:
    return bytes(h[:32].rjust(32, b"\x00"))


def decode_fetch(data: bytes) -> bytes:
    if len(data) < 32:
        raise IPCError("truncated fetch frame")
    return bytes(data[:32])


def encode_shard_update(epoch: int, streams: tuple[int, ...]) -> bytes:
    """Relay -> edge: the relay's shard map is now ``streams`` as of
    ``epoch`` (monotonic per relay)."""
    out = struct.pack(">QH", epoch, len(streams))
    for s in streams:
        out += struct.pack(">I", s)
    return out


def decode_shard_update(data: bytes) -> tuple[int, tuple[int, ...]]:
    """-> (epoch, streams)."""
    try:
        epoch, n = struct.unpack_from(">QH", data, 0)
        streams = struct.unpack_from(">%dI" % n, data, 10)
    except struct.error as exc:
        raise IPCError("truncated shard update: %s" % exc)
    return epoch, tuple(streams)


#: kind(u8) stream(u32) epoch(u64) bucket(i64; -1 = none)
_HANDOFF = struct.Struct(">BIQq")


def encode_handoff(kind: int, stream: int, epoch: int,
                   bucket: int = -1) -> bytes:
    """Handoff control frame (``HANDOFF_BEGIN``/``END``/``ACK``).
    ``bucket`` tags which expiry bucket the surrounding OBJECTS frames
    belong to (resume granularity); -1 when not bucket-scoped."""
    return _HANDOFF.pack(kind, stream, epoch, bucket)


def decode_handoff(data: bytes) -> tuple[int, int, int, int]:
    """-> (kind, stream, epoch, bucket)."""
    try:
        return _HANDOFF.unpack_from(data, 0)
    except struct.error as exc:
        raise IPCError("truncated handoff frame: %s" % exc)
