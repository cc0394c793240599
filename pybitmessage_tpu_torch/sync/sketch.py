"""Salted 64-bit short IDs of inventory hashes (copy of
``pybitmessage_tpu.sync.sketch``, trimmed to ``short_id``).

A short ID is the splitmix64 finalizer applied twice: to the hash's
first little-endian word XOR the salt, then to that XOR the second
word.  The digest folds these IDs with XOR, so removal is exact.  The
invertible sketches built from them are not part of this package yet.
"""

from __future__ import annotations

import struct

_MASK = 0xFFFFFFFFFFFFFFFF
#: splitmix64 finalizer constants
_C1 = 0xBF58476D1CE4E5B9
_C2 = 0x94D049BB133111EB


def _mix64(x: int) -> int:
    """splitmix64 finalizer."""
    x &= _MASK
    x = ((x ^ (x >> 30)) * _C1) & _MASK
    x = ((x ^ (x >> 27)) * _C2) & _MASK
    return x ^ (x >> 31)


def short_id(hash_: bytes, salt: int) -> int:
    """64-bit salted short ID of one 32-byte inventory hash."""
    w0, w1 = struct.unpack_from("<QQ", hash_)
    return _mix64(_mix64(w0 ^ (salt & _MASK)) ^ w1)
