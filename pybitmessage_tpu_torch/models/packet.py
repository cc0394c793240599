"""Wire packet framing (copy of ``pybitmessage_tpu.models.packet``,
trimmed to ``pack_packet``, which the embedded ack needs).

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

from .constants import MAGIC

_HEADER = struct.Struct("!L12sL4s")


class PacketError(ValueError):
    pass


def pack_packet(command: str, payload: bytes = b"") -> bytes:
    cmd = command.encode("ascii")
    if len(cmd) > 12:
        raise PacketError(f"command too long: {command!r}")
    return _HEADER.pack(MAGIC, cmd, len(payload),
                        hashlib.sha512(payload).digest()[:4]) + payload
