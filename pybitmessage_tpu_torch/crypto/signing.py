"""ECDSA signatures (DER) over secp256k1 with SHA256 / legacy SHA1 (copy
of ``pybitmessage_tpu.crypto.signing``, on the pure-Python tier only).

Reference behavior (src/highlevelcrypto.py:70-108): sign with the
configured digest (sha256 default, sha1 legacy); verify accepts either
digest so old-network signatures keep validating.  The node's receive
path verifies through ``crypto/batch.py`` on the card; :func:`verify`
here is the scalar check of a caller that asks for host threads.  The
digest-hint table remembers which digest a pubkey last verified under
and tries it first, so a legacy-SHA1 peer stops paying a doomed SHA256
attempt per object.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict

from ..observability import REGISTRY
from . import fallback
from .keys import priv_scalar32

_DIGESTS = ("sha256", "sha1")

DIGEST_FALLBACKS = REGISTRY.counter(
    "crypto_digest_fallback_total",
    "Signature verifications that missed on the hinted/default digest "
    "and succeeded on a later one (legacy-peer detection)")

#: pubkey -> digest name that last verified; bounded LRU so a pubkey
#: flood cannot grow it unbounded
_HINT_CAP = 4096
_HINTS: OrderedDict[bytes, str] = OrderedDict()
_HINTS_LOCK = threading.Lock()

#: constructor table (``hashlib.new(name)`` costs ~10x a direct call)
_HASHERS = {"sha256": hashlib.sha256, "sha1": hashlib.sha1}


def digest_order(pubkey: bytes) -> tuple[str, ...]:
    """Digest attempt order for ``pubkey``: the remembered hit first,
    the network default (sha256) order otherwise."""
    with _HINTS_LOCK:
        hint = _HINTS.get(pubkey)
        if hint is not None:
            _HINTS.move_to_end(pubkey)
    if hint is None or hint == _DIGESTS[0]:
        return _DIGESTS
    return (hint,) + tuple(d for d in _DIGESTS if d != hint)


def note_digest(pubkey: bytes, digest: str, *, fallback: bool) -> None:
    """Record which digest verified for ``pubkey``; ``fallback`` marks
    an attempt order whose first choice missed.  A default-digest hit
    with no other hint stored writes nothing."""
    if fallback:
        DIGEST_FALLBACKS.inc()
    elif digest == _DIGESTS[0]:
        with _HINTS_LOCK:
            if _HINTS.get(pubkey) in (None, digest):
                return
    with _HINTS_LOCK:
        _HINTS[pubkey] = digest
        _HINTS.move_to_end(pubkey)
        while len(_HINTS) > _HINT_CAP:
            _HINTS.popitem(last=False)


def _hash(data: bytes, digest: str) -> bytes:
    return _HASHERS[digest](data).digest()


def sign(data: bytes, privkey: bytes, digest: str = "sha256") -> bytes:
    """DER-encoded ECDSA signature of ``data`` (RFC 6979 nonce)."""
    if digest not in _DIGESTS:
        raise KeyError(digest)
    return fallback.ecdsa_sign_digest(_hash(data, digest),
                                      priv_scalar32(privkey))


def _verify_one(data: bytes, signature: bytes, pubkey: bytes,
                digest: str) -> bool:
    """One (digest, signature) attempt; False on any malformation."""
    try:
        pub = fallback.decode_point(pubkey)
        r, s = fallback.der_decode_sig(signature)
        e = fallback.digest_to_scalar(_hash(data, digest))
    except ValueError:
        return False
    return fallback.ecdsa_verify_scalars(e, r, s, pub)


def verify(data: bytes, signature: bytes, pubkey: bytes) -> bool:
    """True if ``signature`` verifies under SHA1 *or* SHA256.

    Never raises: malformed signatures/keys simply fail verification.
    Attempt order follows the per-pubkey digest hint.
    """
    for i, digest in enumerate(digest_order(pubkey)):
        if _verify_one(data, signature, pubkey, digest):
            note_digest(pubkey, digest, fallback=i > 0)
            return True
    return False
