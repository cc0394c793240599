"""ECC blind signatures over secp256k1 (copy of
``pybitmessage_tpu.crypto.blindsig``).

Capability parity with the reference's ``pyelliptic/eccblind.py`` /
``eccblindchain.py`` (an ECC blind-signature scheme + a vouching chain,
unit-tested but unused by the core message flow).  This is NOT a port:
instead of the reference's ctypes-OpenSSL ECDSA-style construction this
implements the textbook **blind Schnorr** protocol, which needs only
group arithmetic — taken from the port's pure-Python secp256k1 in
``crypto/fallback.py`` (this is a cold administrative path).

Protocol (all mod the curve order n, G the base point, H = sha256):

- Signer: secret ``x``, public ``X = xG``; per-signature nonce ``r``,
  sends ``R = rG``.
- Requester blinds: picks ``α, β``; ``R' = R + αG + βX``;
  ``c' = H(R' ‖ m)``; sends ``c = c' + β``.
- Signer signs blind: ``s = r + c·x``, sends ``s``.
- Requester unblinds: ``s' = s + α``.  Signature is ``(R', s')``.
- Verify: ``s'·G == R' + H(R' ‖ m)·X``.

The signer never sees ``m`` or the final signature.  Textbook blind
Schnorr is forgeable when a requester may hold **many concurrent open
sessions** against the same key (the ROS / parallel-session attack of
Benhamouda et al. 2021, practical once the requester can open more than
~log2(n) sessions before any closes).  ``BlindSigner`` therefore
*serializes* sessions: at most one nonce is outstanding at a time, and
``new_request`` raises while a session is open.  With sequential
sessions the scheme is the classic Schnorr blind signature (unforgeable
in the ROM under the discrete log + one-more-dlog assumption).
``SignatureChain`` mirrors the reference's eccblindchain role: a root
key vouches for intermediate keys which sign leaf messages, each link
blind-signable.
"""

from __future__ import annotations

import hashlib
import secrets
from dataclasses import dataclass

from .fallback import N, P, base_mult, point_add, point_mult

_INF = None          # point at infinity


def _mul(k: int, point=None):
    """k * point (the base point by default) -> affine or ``_INF``."""
    return base_mult(k) if point is None else point_mult(k, point)


def _encode_point(point) -> bytes:
    if point is _INF:
        return b"\x00"
    x, y = point
    return bytes([2 + (y & 1)]) + x.to_bytes(32, "big")


def _decode_point(data: bytes):
    if data == b"\x00":
        return _INF
    sign, x = data[0], int.from_bytes(data[1:33], "big")
    y_sq = (pow(x, 3, P) + 7) % P
    y = pow(y_sq, (P + 1) // 4, P)
    if pow(y, 2, P) != y_sq:
        raise ValueError("not a curve point")
    if (y & 1) != (sign - 2):
        y = P - y
    return x, y


def _challenge(r_point, message: bytes) -> int:
    return int.from_bytes(
        hashlib.sha256(_encode_point(r_point) + message).digest(),
        "big") % N


@dataclass
class BlindSignature:
    """Final unblinded signature: ``(R', s')`` plus the signer's key."""
    r_point: tuple
    s: int
    pubkey: bytes

    def serialize(self) -> bytes:
        return _encode_point(self.r_point) + self.s.to_bytes(32, "big") \
            + self.pubkey

    @classmethod
    def deserialize(cls, data: bytes) -> "BlindSignature":
        return cls(_decode_point(data[:33]),
                   int.from_bytes(data[33:65], "big"), data[65:98])


class BlindSigner:
    """Holds the signing key; never sees the message it signs."""

    def __init__(self, secret: int | None = None):
        self.secret = secret or (secrets.randbelow(N - 1) + 1)
        self.pub_point = _mul(self.secret)
        # Single open-session slot: (commitment, r) or None.  Concurrent
        # open sessions would enable the parallel-session ROS forgery
        # (see module docstring), so we refuse to open a second one.
        self._session: tuple[bytes, int] | None = None

    @property
    def pubkey(self) -> bytes:
        return _encode_point(self.pub_point)

    def new_request(self) -> bytes:
        """Step 1: a fresh nonce commitment R for one signature.

        Raises ``RuntimeError`` if a session is already open — sessions
        must complete (``sign_blind``) or be abandoned (``abort``)
        strictly one at a time.
        """
        if self._session is not None:
            raise RuntimeError(
                "a blind-signing session is already open; concurrent "
                "sessions enable the ROS parallel-session forgery")
        r = secrets.randbelow(N - 1) + 1
        commitment = _encode_point(_mul(r))
        self._session = (commitment, r)
        return commitment

    def abort(self) -> None:
        """Discard the open session (e.g. requester went away)."""
        self._session = None

    def sign_blind(self, commitment: bytes, blinded_challenge: int) -> int:
        """Step 3: s = r + c·x.  The nonce is single-use (a reused
        Schnorr nonce leaks the key) and the session closes here."""
        if self._session is None or self._session[0] != commitment:
            raise KeyError("no open session for this commitment")
        r = self._session[1]
        self._session = None
        return (r + blinded_challenge * self.secret) % N


class BlindRequester:
    """Blinds a message for signing, unblinds the result."""

    def __init__(self, signer_pubkey: bytes, commitment: bytes,
                 message: bytes):
        self.pubkey = signer_pubkey
        self.message = message
        x_point = _decode_point(signer_pubkey)
        r_point = _decode_point(commitment)
        self.alpha = secrets.randbelow(N - 1) + 1
        self.beta = secrets.randbelow(N - 1) + 1
        self.r_blind = point_add(point_add(r_point, _mul(self.alpha)),
                                 _mul(self.beta, x_point))
        self.challenge = _challenge(self.r_blind, message)

    @property
    def blinded_challenge(self) -> int:
        """What the signer sees: c = c' + β — statistically independent
        of the message."""
        return (self.challenge + self.beta) % N

    def unblind(self, blind_s: int) -> BlindSignature:
        return BlindSignature(self.r_blind, (blind_s + self.alpha) % N,
                              self.pubkey)


def verify(sig: BlindSignature, message: bytes) -> bool:
    """s'·G == R' + H(R' ‖ m)·X."""
    try:
        x_point = _decode_point(sig.pubkey)
    except ValueError:
        return False
    c = _challenge(sig.r_point, message)
    lhs = _mul(sig.s)
    rhs = point_add(sig.r_point, _mul(c, x_point))
    return lhs == rhs


def blind_sign_roundtrip(signer: BlindSigner,
                         message: bytes) -> BlindSignature:
    """The full 3-message protocol in one call (both roles local) —
    what the voucher chain uses to extend itself."""
    commitment = signer.new_request()
    req = BlindRequester(signer.pubkey, commitment, message)
    return req.unblind(signer.sign_blind(commitment,
                                         req.blinded_challenge))


class SignatureChain:
    """Vouching chain (reference eccblindchain.py role): link i's key
    signs link i+1's pubkey; the last key signs the payload.  Valid iff
    every link verifies and the chain starts at the trusted root."""

    def __init__(self, root_pubkey: bytes):
        self.root_pubkey = root_pubkey
        self.links: list[tuple[bytes, BlindSignature]] = []

    def extend(self, signer: BlindSigner, new_pubkey: bytes) -> None:
        expected = self.links[-1][0] if self.links else self.root_pubkey
        if signer.pubkey != expected:
            raise ValueError("chain must be extended by its tip key")
        self.links.append((new_pubkey,
                           blind_sign_roundtrip(signer, new_pubkey)))

    def verify_payload(self, payload: bytes,
                       sig: BlindSignature) -> bool:
        key = self.root_pubkey
        for pub, link_sig in self.links:
            if link_sig.pubkey != key or not verify(link_sig, pub):
                return False
            key = pub
        return sig.pubkey == key and verify(sig, payload)
