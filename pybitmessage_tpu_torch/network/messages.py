"""Wire payload codecs: version, addr, inv/getdata, error, host encoding
(copy of ``pybitmessage_tpu.network.messages``, without the sync and
wire-trace codecs).

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
