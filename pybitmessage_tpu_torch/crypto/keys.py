"""secp256k1 key forms and wire codecs (copy of
``pybitmessage_tpu.crypto.keys``, trimmed to what the receive path
uses).

The batch engine consumes raw forms: 64-byte X||Y points and 32-byte
scalars.  Validation (curve membership, scalar range) costs a field
computation per key; the cached tables below pay it once per distinct
key instead of once per drain item.  Curve checks run on Python
integers (``fallback``).
"""

from __future__ import annotations

import functools
import secrets

from . import fallback

#: OpenSSL NID for secp256k1: the 2-byte curve tag on wire pubkeys
CURVE_TAG = 714

#: secp256k1 group order (SEC2); private keys must be in [1, N-1]
_ORDER = fallback.N


@functools.lru_cache(maxsize=4096)
def pub_point64(pubkey: bytes) -> bytes:
    """65-byte uncompressed pubkey -> validated 64-byte X||Y.

    Raises ValueError for anything not an on-curve uncompressed point.
    """
    fallback.decode_point(pubkey)       # raises when malformed/off curve
    return pubkey[1:]


@functools.lru_cache(maxsize=4096)
def priv_scalar32(privkey: bytes) -> bytes:
    """Validated 32-byte private scalar in [1, N-1]."""
    if len(privkey) != 32:
        raise ValueError("private key must be 32 bytes")
    if not 0 < int.from_bytes(privkey, "big") < _ORDER:
        raise ValueError("private scalar out of range")
    return privkey


def random_private_key() -> bytes:
    """32 random bytes forming a valid scalar."""
    while True:
        key = secrets.token_bytes(32)
        if 0 < int.from_bytes(key, "big") < _ORDER:
            return key


def priv_to_pub(privkey: bytes) -> bytes:
    """32-byte scalar -> 65-byte uncompressed pubkey 0x04 || X || Y."""
    return fallback.priv_to_pub(privkey)


# --- 0x02CA curve-tagged wire format ---------------------------------------

def _strip(b: bytes) -> bytes:
    """BN_bn2bin semantics: minimal big-endian encoding."""
    s = b.lstrip(b"\x00")
    return s if s else b"\x00"


def encode_pubkey_wire(pubkey: bytes) -> bytes:
    """65-byte uncompressed pubkey -> curve(2) || len(2) || X || len(2) || Y,
    coordinates minimally encoded as OpenSSL's BN serialization does."""
    assert len(pubkey) == 65 and pubkey[0] == 4
    x = _strip(pubkey[1:33])
    y = _strip(pubkey[33:65])
    return (CURVE_TAG.to_bytes(2, "big")
            + len(x).to_bytes(2, "big") + x
            + len(y).to_bytes(2, "big") + y)


def decode_pubkey_wire(data: bytes) -> tuple[bytes, int]:
    """Parse a curve-tagged pubkey; returns (65-byte pubkey, consumed).

    Raises ValueError on bad tag / truncation / oversize coordinates.
    """
    if len(data) < 6:
        raise ValueError("truncated pubkey")
    if int.from_bytes(data[:2], "big") != CURVE_TAG:
        raise ValueError("unsupported curve tag")
    i = 2
    coords = []
    for _ in range(2):
        if len(data) < i + 2:
            raise ValueError("truncated pubkey")
        n = int.from_bytes(data[i:i + 2], "big")
        i += 2
        if n > 32 or len(data) < i + n:
            raise ValueError("bad coordinate length")
        coords.append(data[i:i + n].rjust(32, b"\x00"))
        i += n
    return b"\x04" + coords[0] + coords[1], i
