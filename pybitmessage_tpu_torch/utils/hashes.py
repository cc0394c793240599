"""Hash primitives (copy of ``pybitmessage_tpu.utils.hashes``).

The Bitmessage inventory hash and proof-of-work both build on
double-SHA512; addresses additionally use RIPEMD160(SHA512(pubkeys)).
Reference: src/addresses.py:137-143, src/class_addressGenerator.py:150-162.
"""

from __future__ import annotations

import hashlib


def sha512(data: bytes) -> bytes:
    return hashlib.sha512(data).digest()


def double_sha512(data: bytes) -> bytes:
    return hashlib.sha512(hashlib.sha512(data).digest()).digest()


def inventory_hash(object_bytes: bytes) -> bytes:
    """First 32 bytes of double-SHA512 of the serialized object."""
    return double_sha512(object_bytes)[:32]


def ripemd160(data: bytes) -> bytes:
    try:
        return hashlib.new("ripemd160", data).digest()
    except (ValueError, TypeError):  # pragma: no cover - OpenSSL w/o legacy
        return _ripemd160_py(data)


def address_ripe(pub_signing_key: bytes, pub_encryption_key: bytes) -> bytes:
    """RIPE hash binding both public keys: RIPEMD160(SHA512(sign || enc)).

    Keys are in the uncompressed 0x04-prefixed 65-byte form.
    """
    return ripemd160(sha512(pub_signing_key + pub_encryption_key))

# ---------------------------------------------------------------------------
# Pure-python RIPEMD-160 fallback (FIPS-free OpenSSL builds drop it).
# Implemented from the RIPEMD-160 specification (Dobbertin/Bosselaers/Preneel).
# ---------------------------------------------------------------------------

_RHO = [
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [7, 4, 13, 1, 10, 6, 15, 3, 12, 0, 9, 5, 2, 14, 11, 8],
    [3, 10, 14, 4, 9, 15, 8, 1, 2, 7, 0, 6, 13, 11, 5, 12],
    [1, 9, 11, 10, 0, 8, 12, 4, 13, 3, 7, 15, 14, 5, 6, 2],
    [4, 0, 5, 9, 7, 12, 2, 10, 14, 1, 3, 8, 11, 6, 15, 13],
]
_RHO_P = [
    [5, 14, 7, 0, 9, 2, 11, 4, 13, 6, 15, 8, 1, 10, 3, 12],
    [6, 11, 3, 7, 0, 13, 5, 10, 14, 15, 8, 12, 4, 9, 1, 2],
    [15, 5, 1, 3, 7, 14, 6, 9, 11, 8, 12, 2, 10, 0, 4, 13],
    [8, 6, 4, 1, 3, 11, 15, 0, 5, 12, 2, 13, 9, 7, 10, 14],
    [12, 15, 10, 4, 1, 5, 8, 7, 6, 2, 13, 14, 0, 3, 9, 11],
]
_SHIFTS = [
    [11, 14, 15, 12, 5, 8, 7, 9, 11, 13, 14, 15, 6, 7, 9, 8],
    [7, 6, 8, 13, 11, 9, 7, 15, 7, 12, 15, 9, 11, 7, 13, 12],
    [11, 13, 6, 7, 14, 9, 13, 15, 14, 8, 13, 6, 5, 12, 7, 5],
    [11, 12, 14, 15, 14, 15, 9, 8, 9, 14, 5, 6, 8, 6, 5, 12],
    [9, 15, 5, 11, 6, 8, 13, 12, 5, 12, 13, 14, 11, 8, 5, 6],
]
_SHIFTS_P = [
    [8, 9, 9, 11, 13, 15, 15, 5, 7, 7, 8, 11, 14, 14, 12, 6],
    [9, 13, 15, 7, 12, 8, 9, 11, 7, 7, 12, 7, 6, 15, 13, 11],
    [9, 7, 15, 11, 8, 6, 6, 14, 12, 13, 5, 14, 13, 13, 7, 5],
    [15, 5, 8, 11, 14, 14, 6, 14, 6, 9, 12, 9, 12, 5, 15, 8],
    [8, 5, 12, 9, 12, 5, 14, 6, 8, 13, 6, 5, 15, 13, 11, 11],
]
_K = [0x00000000, 0x5A827999, 0x6ED9EBA1, 0x8F1BBCDC, 0xA953FD4E]
_K_P = [0x50A28BE6, 0x5C4DD124, 0x6D703EF3, 0x7A6D76E9, 0x00000000]

_MASK = 0xFFFFFFFF


def _rol(x: int, n: int) -> int:
    return ((x << n) | (x >> (32 - n))) & _MASK


def _f(j: int, x: int, y: int, z: int) -> int:
    if j == 0:
        return x ^ y ^ z
    if j == 1:
        return (x & y) | (~x & z)
    if j == 2:
        return (x | ~y) ^ z
    if j == 3:
        return (x & z) | (y & ~z)
    return x ^ (y | ~z)


def _ripemd160_py(message: bytes) -> bytes:
    h = [0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0]
    padded = message + b"\x80"
    padded += b"\x00" * ((56 - len(padded) % 64) % 64)
    padded += (len(message) * 8).to_bytes(8, "little")
    for block_off in range(0, len(padded), 64):
        block = padded[block_off:block_off + 64]
        x = [int.from_bytes(block[i:i + 4], "little") for i in range(0, 64, 4)]
        a, b, c, d, e = h
        ap, bp, cp, dp, ep = h
        for rnd in range(5):
            for i in range(16):
                t = _rol((a + _f(rnd, b, c, d) + x[_RHO[rnd][i]] + _K[rnd]) & _MASK,
                         _SHIFTS[rnd][i]) + e
                a, e, d, c, b = e, d, _rol(c, 10), b, t & _MASK
                t = _rol((ap + _f(4 - rnd, bp, cp, dp) + x[_RHO_P[rnd][i]]
                          + _K_P[rnd]) & _MASK, _SHIFTS_P[rnd][i]) + ep
                ap, ep, dp, cp, bp = ep, dp, _rol(cp, 10), bp, t & _MASK
        t = (h[1] + c + dp) & _MASK
        h[1] = (h[2] + d + ep) & _MASK
        h[2] = (h[3] + e + ap) & _MASK
        h[3] = (h[4] + a + bp) & _MASK
        h[4] = (h[0] + b + cp) & _MASK
        h[0] = t
    return b"".join(v.to_bytes(4, "little") for v in h)
