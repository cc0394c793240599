"""Wire packet framing (copy of ``pybitmessage_tpu.models.packet``,
without the ``Packet`` dataclass).

A message on the wire is a 24-byte header followed by the payload:

    u32  magic      0xE9BEB4D9
    12s  command    NUL-padded ASCII
    u32  length     payload length
    4s   checksum   first 4 bytes of SHA512(payload)

Reference: src/protocol.py:62-63 (``Header = Struct('!L12sL4s')``) and
src/protocol.py:292-300 (CreatePacket).
"""

from __future__ import annotations

import hashlib
import struct

from .constants import MAGIC, MAX_MESSAGE_SIZE

_HEADER = struct.Struct("!L12sL4s")
HEADER_LEN = _HEADER.size  # 24


class PacketError(ValueError):
    pass


def _checksum(payload: bytes) -> bytes:
    return hashlib.sha512(payload).digest()[:4]


def pack_packet(command: str, payload: bytes = b"") -> bytes:
    cmd = command.encode("ascii")
    if len(cmd) > 12:
        raise PacketError(f"command too long: {command!r}")
    return _HEADER.pack(MAGIC, cmd, len(payload), _checksum(payload)) + payload


def unpack_header(header: bytes) -> tuple[str, int, bytes]:
    """Parse a 24-byte header -> (command, payload_length, checksum).

    Raises :class:`PacketError` on bad magic or oversize length; the caller
    handles resync-on-bad-magic (reference: src/network/bmproto.py:85-104).
    """
    if len(header) < HEADER_LEN:
        raise PacketError("short header")
    magic, cmd, length, checksum = _HEADER.unpack_from(header)
    if magic != MAGIC:
        raise PacketError("bad magic")
    if length > MAX_MESSAGE_SIZE:
        raise PacketError(f"payload length {length} exceeds protocol maximum")
    return cmd.rstrip(b"\x00").decode("ascii", "replace"), length, checksum


def verify_payload(payload: bytes, checksum: bytes) -> bool:
    return _checksum(payload) == checksum
