"""Hash primitives of the PoW path (copy of ``pybitmessage_tpu.utils.hashes``,
trimmed to what the send path uses)."""

from __future__ import annotations

import hashlib


def sha512(data: bytes) -> bytes:
    return hashlib.sha512(data).digest()


def double_sha512(data: bytes) -> bytes:
    return hashlib.sha512(hashlib.sha512(data).digest()).digest()
