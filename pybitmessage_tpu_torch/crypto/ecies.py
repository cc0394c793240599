"""ECIES over secp256k1, the Bitmessage encrypted-payload wire format
(copy of ``pybitmessage_tpu.crypto.ecies``, on the pure-Python tier).

Layout::

    IV(16) || ephem-pubkey(0x02CA-tagged) || AES-256-CBC ciphertext || MAC(32)

KDF: key = SHA512(ECDH_raw_x); key_e = key[:32] (AES), key_m = key[32:]
(HMAC-SHA256).  The MAC covers everything before it and is checked in
constant time BEFORE decryption, so the per-candidate cost of a trial
decrypt is one ECDH and one HMAC, never AES.
"""

from __future__ import annotations

import hmac as hmac_mod
import os
from hashlib import sha256, sha512
from typing import NamedTuple

from . import fallback
from .keys import decode_pubkey_wire, encode_pubkey_wire, random_private_key


class DecryptionError(ValueError):
    """MAC mismatch or malformed payload, indistinguishable on purpose."""


class ParsedPayload(NamedTuple):
    """One ECIES payload split into its wire fields; ``macdata`` is the
    MAC's coverage (everything before the tag)."""
    iv: bytes
    ephem_pub: bytes        # 65-byte uncompressed point
    ciphertext: bytes
    tag: bytes
    macdata: bytes


def parse_payload(payload: bytes) -> ParsedPayload:
    """Split ``payload`` into fields; raises :class:`DecryptionError` on
    any malformation (truncation, bad curve tag, empty or ragged
    ciphertext)."""
    try:
        if len(payload) < 16 + 6 + 16 + 32:
            raise ValueError("payload too short")
        iv = payload[:16]
        ephem_pub, used = decode_pubkey_wire(payload[16:len(payload) - 32])
        ct = payload[16 + used:len(payload) - 32]
        tag = payload[len(payload) - 32:]
        if len(ct) == 0 or len(ct) % 16:
            raise ValueError("bad ciphertext length")
        return ParsedPayload(iv, ephem_pub, ct, tag,
                             payload[:len(payload) - 32])
    except DecryptionError:
        raise
    except Exception as exc:
        raise DecryptionError("decryption failed") from exc


def kdf(shared_x: bytes) -> tuple[bytes, bytes]:
    """SHA512 KDF over the raw ECDH X -> (aes_key, mac_key)."""
    key = sha512(shared_x).digest()
    return key[:32], key[32:]


def mac_ok(mac_key: bytes, macdata: bytes, tag: bytes) -> bool:
    """Constant-time HMAC-SHA256 acceptance."""
    expect = hmac_mod.new(mac_key, macdata, sha256).digest()
    return hmac_mod.compare_digest(expect, tag)


def _pkcs7_pad(data: bytes) -> bytes:
    n = 16 - len(data) % 16
    return data + bytes([n]) * n


def _pkcs7_unpad(data: bytes) -> bytes:
    if not data or len(data) % 16:
        raise ValueError("bad padded length")
    n = data[-1]
    if not 1 <= n <= 16 or data[-n:] != bytes([n]) * n:
        raise ValueError("bad PKCS7 padding")
    return data[:-n]


def finish_decrypt(aes_key: bytes, parsed: ParsedPayload) -> bytes:
    """AES-decrypt and unpad a MAC-approved payload."""
    return _pkcs7_unpad(fallback.aes256_cbc(False, aes_key, parsed.iv,
                                            parsed.ciphertext))


def encrypt(data: bytes, recipient_pubkey: bytes, *,
            ephem_priv: bytes | None = None, iv: bytes | None = None) -> bytes:
    """Encrypt to a 65-byte uncompressed secp256k1 public key.

    ``ephem_priv`` and ``iv`` default to fresh random values; a caller
    that needs reproducible payloads (a seeded test) passes its own.
    """
    if ephem_priv is None:
        ephem_priv = random_private_key()
    if iv is None:
        iv = os.urandom(16)
    key_e, key_m = kdf(fallback.ecdh_x(ephem_priv, recipient_pubkey))
    ct = fallback.aes256_cbc(True, key_e, iv, _pkcs7_pad(data))
    blob = iv + encode_pubkey_wire(fallback.priv_to_pub(ephem_priv)) + ct
    return blob + hmac_mod.new(key_m, blob, sha256).digest()


def decrypt(payload: bytes, privkey: bytes) -> bytes:
    """Decrypt an ECIES payload with a 32-byte private key.

    Raises :class:`DecryptionError` on any malformation or MAC failure
    (one exception type so callers can't leak which check failed).
    """
    parsed = parse_payload(payload)
    try:
        key_e, key_m = kdf(fallback.ecdh_x(privkey, parsed.ephem_pub))
        if not mac_ok(key_m, parsed.macdata, parsed.tag):
            raise ValueError("MAC mismatch")
        return finish_decrypt(key_e, parsed)
    except DecryptionError:
        raise
    except Exception as exc:
        raise DecryptionError("decryption failed") from exc
