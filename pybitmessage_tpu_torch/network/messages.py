"""Wire payload codecs: version, addr, inv/getdata, error, host encoding
and the set-reconciliation and wire-trace codecs (copy of
``pybitmessage_tpu.network.messages``).

Reference formats: src/protocol.py:303-395 (version/error assembly),
src/network/bmproto.py:443-512 (addr/inv parsing patterns).
"""

from __future__ import annotations

import ipaddress
import socket
import struct
import time
from dataclasses import dataclass

from ..models.constants import (
    MAX_ADDR_COUNT, MAX_INV_COUNT, NODE_DANDELION, NODE_NETWORK,
    ONION_PREFIX, PROTOCOL_VERSION,
)
from ..utils.varint import decode_varint, encode_varint

USER_AGENT = "/pybitmessage-tpu:0.1.0/"


class MessageError(ValueError):
    pass


def encode_host(host: str) -> bytes:
    """16-byte address: IPv4-mapped, IPv6, or onion (reference:
    protocol.py:96-110 — 'fd87:d87e:eb43' prefix + base32 body)."""
    if host.endswith(".onion"):
        import base64
        body = host.split(".")[0].upper()
        body += "=" * ((8 - len(body) % 8) % 8)
        raw = base64.b32decode(body)
        if len(raw) != 10:
            # the 16-byte addr field holds prefix(6)+10 bytes: only
            # v2-style (16-char) onions are wire-representable —
            # truncating a v3 onion would flood a garbage address
            raise MessageError(f"onion host not wire-encodable: {host!r}")
        return ONION_PREFIX + raw
    try:
        packed = socket.inet_pton(socket.AF_INET, host)
        return b"\x00" * 10 + b"\xff\xff" + packed
    except OSError:
        return socket.inet_pton(socket.AF_INET6, host)


def decode_host(data: bytes) -> str:
    """Inverse of :func:`encode_host`."""
    if data[:6] == ONION_PREFIX:
        import base64
        return base64.b32encode(data[6:]).decode("ascii").lower() + ".onion"
    if data[:12] == b"\x00" * 10 + b"\xff\xff":
        return socket.inet_ntop(socket.AF_INET, data[12:16])
    return socket.inet_ntop(socket.AF_INET6, data[:16])


def network_group(host: str) -> bytes:
    """Anti-Sybil group key: /16 for IPv4, /32 for IPv6 (reference:
    protocol.py:122-147)."""
    try:
        ip = ipaddress.ip_address(host)
    except ValueError:
        return host.encode()  # onion / hostname: group by itself
    raw = ip.packed
    if isinstance(ip, ipaddress.IPv4Address):
        return b"v4" + raw[:2]
    return b"v6" + raw[:4]


def is_private_host(host: str) -> bool:
    try:
        ip = ipaddress.ip_address(host)
    except ValueError:
        return False
    return (ip.is_private or ip.is_loopback or ip.is_link_local
            or ip.is_multicast or ip.is_reserved or ip.is_unspecified)


@dataclass
class VersionPayload:
    protocol_version: int = PROTOCOL_VERSION
    services: int = NODE_NETWORK | NODE_DANDELION
    timestamp: int = 0
    remote_host: str = "127.0.0.1"
    remote_port: int = 8444
    my_port: int = 8444
    nonce: bytes = b"\x00" * 8
    user_agent: str = USER_AGENT
    streams: tuple[int, ...] = (1,)
    remote_services: int = 1

    def encode(self) -> bytes:
        out = struct.pack(">L", self.protocol_version)
        out += struct.pack(">q", self.services)
        out += struct.pack(">q", self.timestamp or int(time.time()))
        # addrRecv: the peer as we see it (services ignored remotely)
        out += struct.pack(">q", self.remote_services)
        try:
            host16 = encode_host(self.remote_host)[:16]
        except (OSError, ValueError):
            # proxied hostname / v3 onion: not wire-encodable — send a
            # placeholder; the peer keys off the socket address anyway
            host16 = b"\x00" * 10 + b"\xff\xff" + b"\x7f\x00\x00\x01"
        out += host16
        out += struct.pack(">H", self.remote_port)
        # addrFrom: our services + a placeholder loopback address — the
        # peer uses the real socket address (reference protocol.py:344-347)
        out += struct.pack(">q", self.services)
        out += b"\x00" * 10 + b"\xff\xff" + struct.pack(">L", 2130706433)
        out += struct.pack(">H", self.my_port)
        out += self.nonce[:8].ljust(8, b"\x00")
        ua = self.user_agent.encode("utf-8")
        out += encode_varint(len(ua)) + ua
        out += encode_varint(len(self.streams))
        for s in sorted(self.streams):
            out += encode_varint(s)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "VersionPayload":
        if len(data) < 83:
            raise MessageError("version payload too short")
        ver, services, ts = struct.unpack_from(">Lqq", data)
        # addrRecv 26 bytes at 20, addrFrom 26 bytes at 46
        my_as_seen = decode_host(data[28:44])
        my_port_as_seen = struct.unpack_from(">H", data, 44)[0]
        their_services2 = struct.unpack_from(">q", data, 46)[0]
        their_port = struct.unpack_from(">H", data, 70)[0]
        nonce = data[72:80]
        i = 80
        ua_len, n = decode_varint(data, i)
        i += n
        if ua_len > 5000:
            raise MessageError("user agent too long")
        ua = data[i:i + ua_len].decode("utf-8", "replace")
        i += ua_len
        nstreams, n = decode_varint(data, i)
        i += n
        if nstreams > 160000:
            raise MessageError("too many streams")
        streams = []
        for _ in range(min(nstreams, 500)):
            s, n = decode_varint(data, i)
            i += n
            streams.append(s)
        return cls(ver, services, ts, my_as_seen, my_port_as_seen,
                   their_port, nonce, ua, tuple(streams), their_services2)


@dataclass
class AddrEntry:
    time: int
    stream: int
    services: int
    host: str
    port: int


def encode_addr(entries: list[AddrEntry]) -> bytes:
    entries = entries[:MAX_ADDR_COUNT]
    out = encode_varint(len(entries))
    for e in entries:
        out += struct.pack(">QIQ", e.time, e.stream, e.services)
        out += encode_host(e.host)[:16]
        out += struct.pack(">H", e.port)
    return out


def decode_addr(data: bytes) -> list[AddrEntry]:
    count, i = decode_varint(data)
    if count > MAX_ADDR_COUNT:
        raise MessageError("addr count exceeds protocol maximum")
    out = []
    for _ in range(count):
        if len(data) < i + 38:
            raise MessageError("truncated addr entry")
        t, stream, services = struct.unpack_from(">QIQ", data, i)
        host = decode_host(data[i + 20:i + 36])
        port = struct.unpack_from(">H", data, i + 36)[0]
        i += 38
        out.append(AddrEntry(t, stream, services, host, port))
    return out


def encode_inv(hashes: list[bytes]) -> bytes:
    hashes = hashes[:MAX_INV_COUNT]
    return encode_varint(len(hashes)) + b"".join(hashes)


def decode_inv(data: bytes) -> list[bytes]:
    count, i = decode_varint(data)
    if count > MAX_INV_COUNT:
        raise MessageError("inv count exceeds protocol maximum")
    if len(data) < i + 32 * count:
        raise MessageError("truncated inv")
    return [data[i + 32 * k:i + 32 * (k + 1)] for k in range(count)]


# -- set-reconciliation sync messages -----------------------------------------
#
# Three commands carry the reconciliation protocol:
#   sketchreq  — open a round: session salt + agreed sketch capacity
#                (IBLT rounds), or the initiator's bucket summaries
#                (digest catch-up on establishment);
#   sketch     — the responder's IBLT cells (or its own summaries);
#   recondiff  — the initiator's decoded difference: full hashes the
#                responder is missing + short IDs the initiator wants.

SKETCH_KIND_IBLT = 0
SKETCH_KIND_DIGEST = 1
RECONDIFF_OK = 0
RECONDIFF_DECODE_FAILED = 1
#: wire guards mirroring sync/sketch.py MAX_CELLS / digest buckets
MAX_SKETCH_CELLS = 1 << 16
MAX_DIGEST_BUCKETS = 4096
_SKETCH_CELL_BYTES = 13  # mirrors sync/sketch.py CELL_BYTES


def _encode_summaries(summaries: dict[int, list[tuple[int, int]]]) -> bytes:
    out = encode_varint(len(summaries))
    for stream in sorted(summaries):
        buckets = summaries[stream]
        out += encode_varint(stream) + encode_varint(len(buckets))
        for count, xor in buckets:
            out += encode_varint(count) + struct.pack(">Q", xor)
    return out


def _decode_summaries(data: bytes, i: int
                      ) -> tuple[dict[int, list[tuple[int, int]]], int]:
    nstreams, n = decode_varint(data, i)
    i += n
    if nstreams > 256:
        raise MessageError("too many digest streams")
    out: dict[int, list[tuple[int, int]]] = {}
    for _ in range(nstreams):
        stream, n = decode_varint(data, i)
        i += n
        nbuckets, n = decode_varint(data, i)
        i += n
        if nbuckets > MAX_DIGEST_BUCKETS:
            raise MessageError("digest bucket count exceeds maximum")
        buckets = []
        for _ in range(nbuckets):
            count, n = decode_varint(data, i)
            i += n
            if len(data) < i + 8:
                raise MessageError("truncated digest summary")
            xor = struct.unpack_from(">Q", data, i)[0]
            i += 8
            buckets.append((count, xor))
        out[stream] = buckets
    return out, i


def encode_sketchreq(kind: int, salt: int, capacity: int, set_size: int,
                     summaries: dict[int, list[tuple[int, int]]]
                     | None = None) -> bytes:
    out = encode_varint(kind) + struct.pack(">Q", salt & (2**64 - 1))
    out += encode_varint(capacity) + encode_varint(set_size)
    if kind == SKETCH_KIND_DIGEST:
        out += _encode_summaries(summaries or {})
    return out


def decode_sketchreq(data: bytes):
    kind, i = decode_varint(data)
    if len(data) < i + 8:
        raise MessageError("truncated sketchreq")
    salt = struct.unpack_from(">Q", data, i)[0]
    i += 8
    capacity, n = decode_varint(data, i)
    i += n
    set_size, n = decode_varint(data, i)
    i += n
    if capacity > MAX_SKETCH_CELLS:
        raise MessageError("sketch capacity exceeds maximum")
    summaries = None
    if kind == SKETCH_KIND_DIGEST:
        summaries, i = _decode_summaries(data, i)
    return kind, salt, capacity, set_size, summaries


def encode_sketch(kind: int, salt: int, set_size: int,
                  cells: bytes = b"",
                  summaries: dict[int, list[tuple[int, int]]]
                  | None = None) -> bytes:
    out = encode_varint(kind) + struct.pack(">Q", salt & (2**64 - 1))
    out += encode_varint(set_size)
    if kind == SKETCH_KIND_DIGEST:
        out += _encode_summaries(summaries or {})
    else:
        ncells, rem = divmod(len(cells), _SKETCH_CELL_BYTES)
        if rem:
            raise MessageError("sketch cell blob not cell-aligned")
        out += encode_varint(ncells) + cells
    return out


def decode_sketch(data: bytes):
    kind, i = decode_varint(data)
    if len(data) < i + 8:
        raise MessageError("truncated sketch")
    salt = struct.unpack_from(">Q", data, i)[0]
    i += 8
    set_size, n = decode_varint(data, i)
    i += n
    cells, summaries = b"", None
    if kind == SKETCH_KIND_DIGEST:
        summaries, i = _decode_summaries(data, i)
    else:
        ncells, n = decode_varint(data, i)
        i += n
        if ncells > MAX_SKETCH_CELLS:
            raise MessageError("sketch cell count exceeds maximum")
        end = i + ncells * _SKETCH_CELL_BYTES
        if len(data) < end:
            raise MessageError("truncated sketch cells")
        cells = data[i:end]
    return kind, salt, set_size, cells, summaries


def encode_recondiff(flags: int, salt: int, diff_size: int,
                     missing: list[bytes],
                     want_ids: list[int]) -> bytes:
    missing = missing[:MAX_INV_COUNT]
    want_ids = want_ids[:MAX_INV_COUNT]
    # salt binds the verdict to ONE round — gossip and catch-up rounds
    # can be in flight on the same connection simultaneously, and a
    # failure verdict consumed by the wrong round would tear down
    # state it does not own.  diff_size = the initiator's decoded
    # symmetric-difference total — two cheap bytes that let the
    # responder train its own capacity estimator (it never decodes).
    out = encode_varint(flags) + struct.pack(">Q", salt & (2**64 - 1))
    out += encode_varint(diff_size)
    out += encode_varint(len(missing)) + b"".join(missing)
    out += encode_varint(len(want_ids))
    for id_ in want_ids:
        out += struct.pack(">Q", id_ & (2**64 - 1))
    return out


def decode_recondiff(data: bytes):
    flags, i = decode_varint(data)
    if len(data) < i + 8:
        raise MessageError("truncated recondiff")
    salt = struct.unpack_from(">Q", data, i)[0]
    i += 8
    diff_size, n = decode_varint(data, i)
    i += n
    nmissing, n = decode_varint(data, i)
    i += n
    if nmissing > MAX_INV_COUNT:
        raise MessageError("recondiff hash count exceeds maximum")
    if len(data) < i + 32 * nmissing:
        raise MessageError("truncated recondiff hashes")
    missing = [data[i + 32 * k:i + 32 * (k + 1)] for k in range(nmissing)]
    i += 32 * nmissing
    nwant, n = decode_varint(data, i)
    i += n
    if nwant > MAX_INV_COUNT:
        raise MessageError("recondiff id count exceeds maximum")
    if len(data) < i + 8 * nwant:
        raise MessageError("truncated recondiff ids")
    want = [struct.unpack_from(">Q", data, i + 8 * k)[0]
            for k in range(nwant)]
    return flags, salt, diff_size, missing, want


# -- wire trace context -------------------------------------------------------
#
# NODE_TRACE peers append a fixed 32-byte trailer (16B trace id + 8B
# parent span + 8B send-time micros) to sync-round payloads, and push
# objects as `tobject` frames (trailer-prefixed object payload).  The
# trailer travels ONLY between peers that both advertised NODE_TRACE,
# so legacy decoders never see the extra bytes.

def append_trace_ctx(payload: bytes, ctx) -> bytes:
    """``payload + ctx.encode()`` (ctx stamped with the send time)."""
    from ..observability.tracing import TraceContext
    return payload + TraceContext(ctx.trace_id, ctx.parent_span).encode()


def split_trace_ctx(payload: bytes):
    """Inverse of :func:`append_trace_ctx`: ``(payload, ctx)``.
    Raises :class:`MessageError` when the trailer cannot be there —
    callers only split on trace-negotiated connections, where every
    sync payload carries it."""
    from ..observability.tracing import TRACE_CTX_LEN, TraceContext
    if len(payload) < TRACE_CTX_LEN:
        raise MessageError("payload too short for a trace trailer")
    try:
        ctx = TraceContext.decode(payload[-TRACE_CTX_LEN:])
    except ValueError as exc:
        raise MessageError("bad trace trailer: %s" % exc) from exc
    return payload[:-TRACE_CTX_LEN], ctx


def encode_error(fatal: int = 0, ban_time: int = 0,
                 inventory_vector: bytes = b"", text: str = "") -> bytes:
    t = text.encode("utf-8")
    return (encode_varint(fatal) + encode_varint(ban_time)
            + encode_varint(len(inventory_vector)) + inventory_vector
            + encode_varint(len(t)) + t)


def decode_error(data: bytes):
    fatal, i = decode_varint(data)
    ban, n = decode_varint(data, i)
    i += n
    ivlen, n = decode_varint(data, i)
    i += n
    iv = data[i:i + ivlen]
    i += ivlen
    tlen, n = decode_varint(data, i)
    i += n
    return fatal, ban, iv, data[i:i + tlen].decode("utf-8", "replace")
