"""ECDSA digest bookkeeping of the receive path (copy of
``pybitmessage_tpu.crypto.signing``, trimmed to what the batch engine
uses).

Verification accepts a signature under SHA256 or legacy SHA1.  The
digest-hint table remembers which digest a pubkey last verified under
and tries it first, so a legacy-SHA1 peer stops paying a doomed SHA256
attempt per object.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict

_DIGESTS = ("sha256", "sha1")

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
    if not fallback and digest == _DIGESTS[0]:
        with _HINTS_LOCK:
            if _HINTS.get(pubkey) in (None, digest):
                return
    with _HINTS_LOCK:
        _HINTS[pubkey] = digest
        _HINTS.move_to_end(pubkey)
        while len(_HINTS) > _HINT_CAP:
            _HINTS.popitem(last=False)
