"""secp256k1 key management and wire formats (copy of
``pybitmessage_tpu.crypto.keys``, on the pure-Python tier).

Bulk derivation, :func:`priv_to_pub_many`, is one fixed-base launch on
the card (``CudaSecp.base_mult_batch``: the ECDH kernel with P = G);
the address grinders derive their candidates through it in batches of
:data:`GRIND_BATCH` tries and keep the reference's order, so a
passphrase gives the same address here as in the JAX package.

The batch engine consumes raw forms: 64-byte X||Y points and 32-byte
scalars.  Validation (curve membership, scalar range) costs a field
computation per key; the cached tables below pay it once per distinct
key instead of once per drain item.  Curve checks run on Python
integers (``fallback``).
"""

from __future__ import annotations

import functools
import hashlib
import secrets
from typing import Callable

from ..utils.base58 import b58decode, b58encode
from ..utils.hashes import address_ripe
from ..utils.varint import encode_varint
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


def priv_to_pub_many(privkeys: list[bytes], device=None) -> list[bytes]:
    """Batch key derivation: one ``CudaSecp(device).base_mult_batch``
    call (``None``: the CUDA card, raising without one; ``"cpu"``: the
    kernel's plain torch version).  Raises ValueError on any
    out-of-range scalar, like :func:`priv_to_pub`, before the device is
    involved; a device failure reaches the caller."""
    from .gpu import CudaSecp
    if not privkeys:
        return []
    scalars = b"".join(priv_scalar32(k) for k in privkeys)
    points = CudaSecp(device).base_mult_batch(scalars, len(privkeys))
    if any(p is None for p in points):
        raise ValueError("private scalar out of range")
    return [b"\x04" + p for p in points]


def host_priv_to_pub_many(privkeys: list[bytes]) -> list[bytes]:
    """Key derivation one pure-Python multiplication at a time: the
    ``derive`` of a caller that asks for host crypto."""
    return [fallback.priv_to_pub(k) for k in privkeys]


# --- address grinding --------------------------------------------------------

#: candidate tries derived per batch by the grinders
GRIND_BATCH = 256

#: ``derive(privkeys) -> pubkeys``: how a grinder derives its candidates
Derive = Callable[[list], list]


def deterministic_private_key(passphrase: bytes, nonce: int) -> bytes:
    """sha512(passphrase || varint(nonce))[:32] — the deterministic-
    address derivation (reference: class_addressGenerator.py:246-271)."""
    return hashlib.sha512(passphrase + encode_varint(nonce)).digest()[:32]


def grind_deterministic_keys(passphrase: bytes, leading_zeros: int = 1,
                             start_nonce: int = 0, *,
                             derive: Derive | None = None,
                             batch: int = GRIND_BATCH):
    """Find the first (signing, encryption) deterministic key pair whose
    combined RIPE starts with ``leading_zeros`` zero bytes.

    Nonce pairs (n, n+1) advance by 2 per attempt (reference:
    class_addressGenerator.py:246-271); ``batch`` attempts are derived
    in one ``derive`` call (default :func:`priv_to_pub_many` on the
    card) and scanned in order, so the first hit is the reference's.
    Returns (priv_signing, priv_encryption, ripe, signing_nonce).
    """
    derive = derive or priv_to_pub_many
    zeros = b"\x00" * leading_zeros
    nonce = start_nonce
    while True:
        privs = [deterministic_private_key(passphrase, nonce + i)
                 for i in range(2 * batch)]
        pubs = derive(privs)
        for i in range(0, 2 * batch, 2):
            ripe = address_ripe(pubs[i], pubs[i + 1])
            if ripe[:leading_zeros] == zeros:
                return privs[i], privs[i + 1], ripe, nonce + i
        nonce += 2 * batch


def grind_random_keys(leading_zeros: int = 1, *,
                      derive: Derive | None = None,
                      batch: int = GRIND_BATCH):
    """Random-address grind: fixed signing key, fresh encryption keys
    until the RIPE has the demanded zero prefix (reference:
    class_addressGenerator.py:119-214), ``batch`` candidates per
    ``derive`` call.  Returns (sk, ek, ripe)."""
    derive = derive or priv_to_pub_many
    zeros = b"\x00" * leading_zeros
    sk = random_private_key()
    pub_sk = None
    while True:
        eks = [random_private_key() for _ in range(batch)]
        pubs = derive(eks if pub_sk is not None else [sk] + eks)
        if pub_sk is None:
            pub_sk, pubs = pubs[0], pubs[1:]
        for ek, pub in zip(eks, pubs):
            ripe = address_ripe(pub_sk, pub)
            if ripe[:leading_zeros] == zeros:
                return sk, ek, ripe


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


# --- WIF --------------------------------------------------------------------

def wif_encode(privkey: bytes) -> str:
    """0x80 || key || first4(sha256d) in base58 (reference:
    class_addressGenerator.py WIF encode, shared.py:79-105 decode)."""
    raw = b"\x80" + privkey
    check = hashlib.sha256(hashlib.sha256(raw).digest()).digest()[:4]
    return b58encode(raw + check)


def wif_decode(wif: str) -> bytes:
    raw = b58decode(wif)
    payload, check = raw[:-4], raw[-4:]
    if hashlib.sha256(hashlib.sha256(payload).digest()).digest()[:4] != check:
        raise ValueError("WIF checksum mismatch")
    if not payload.startswith(b"\x80"):
        raise ValueError("WIF missing 0x80 prefix")
    return payload[1:]
