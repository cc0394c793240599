"""Bucketed inventory digests (copy of ``pybitmessage_tpu.sync.digest``).

An :class:`InventoryDigest` keeps, per stream, ``(count, xor of short
IDs)`` for each of ``buckets`` buckets over the hashes folded into it.
``add`` folds a hash in and ``discard`` / ``clean`` unfold it (XOR makes
removal exact), so the summaries never need a rescan.

In this package the digest is the light-client filter: ``add`` takes an
optional *routing key* so the subscription plane (``roles/
subscription.py``) buckets a tagged object by its address-derived tag
instead of its inventory hash; a client then derives its buckets from
its own addresses without revealing them.  The key's first two bytes
are kept per entry, so ``resize`` re-buckets the whole digest in one
pass when the bucket count changes.

Short IDs use a FIXED zero salt (``DIGEST_SALT``): every side must
bucket and mix identically.
"""

from __future__ import annotations

import threading

from .sketch import short_id

#: buckets per stream; hash -> bucket via its first two bytes (the
#: 16-bit key word supports up to 65536 buckets — the light-client
#: anonymity knob sweeps 64..1024, and the wire format already allows
#: MAX_DIGEST_BUCKETS=4096)
DIGEST_BUCKETS = 64
#: the session-independent salt digest IDs are mixed with
DIGEST_SALT = 0


def bucket_of(hash_: bytes, buckets: int = DIGEST_BUCKETS) -> int:
    return ((hash_[0] << 8) | hash_[1]) % buckets


class InventoryDigest:
    """Incremental per-stream bucket summaries over unexpired hashes.

    ``streams`` optionally restricts the digest to a set of streams:
    a hash of another stream is never folded.  ``None`` (default)
    folds every stream.
    """

    def __init__(self, buckets: int = DIGEST_BUCKETS,
                 streams: "set[int] | None" = None):
        self.buckets = buckets
        self.streams = set(streams) if streams is not None else None
        self._lock = threading.RLock()
        #: hash -> (stream, expires, short_id, key_word) — exact
        #: removal support; key_word is the routing key's first two
        #: bytes (== the hash's unless ``add`` was given an explicit
        #: key), so the entry's bucket is recomputable under any
        #: bucket count
        self._entries: dict[bytes, tuple[int, int, int, int]] = {}
        #: stream -> ([count]*buckets, [xor]*buckets)
        self._streams: dict[int, tuple[list[int], list[int]]] = {}
        #: digests served without an inventory rescan (metrics/tests)
        self.incremental_updates = 0

    def _tables(self, stream: int) -> tuple[list[int], list[int]]:
        t = self._streams.get(stream)
        if t is None:
            t = self._streams[stream] = ([0] * self.buckets,
                                         [0] * self.buckets)
        return t

    # -- incremental maintenance ---------------------------------------------

    def add(self, hash_: bytes, stream: int, expires: int,
            key: bytes | None = None) -> None:
        """Fold one hash in.  ``key`` (optional) is the routing key the
        entry buckets under — the subscription plane passes the
        object's address-derived tag so clients can subscribe by
        address; ``None`` keeps the historical hash-bucketed behavior
        (peer sync must bucket identically on both sides)."""
        if self.streams is not None and stream not in self.streams:
            return  # out-of-shard: never folded, never announced
        kw = bucket_of(key if key else hash_, 1 << 16)
        with self._lock:
            if hash_ in self._entries:
                return
            sid = short_id(hash_, DIGEST_SALT)
            self._entries[hash_] = (stream, expires, sid, kw)
            counts, xors = self._tables(stream)
            b = kw % self.buckets
            counts[b] += 1
            xors[b] ^= sid
            self.incremental_updates += 1

    def discard(self, hash_: bytes) -> None:
        with self._lock:
            entry = self._entries.pop(hash_, None)
            if entry is None:
                return
            stream, _, sid, kw = entry
            counts, xors = self._tables(stream)
            b = kw % self.buckets
            counts[b] -= 1
            xors[b] ^= sid
            self.incremental_updates += 1

    def clean(self, now: int) -> int:
        """Unfold entries expired at ``now``; returns how many left.
        Expired objects must stop being announced even while the SQL
        table still holds them inside its 3 h purge grace."""
        with self._lock:
            stale = [h for h, (_, exp, _, _) in self._entries.items()
                     if exp <= now]
            for h in stale:
                self.discard(h)
            return len(stale)

    def rebuild(self, seed) -> None:
        """(Re)build from ``(hash, stream, expires)`` triples — the one
        full scan, paid at attach time only.  A trailing 4th element
        per row (the routing key) is honored when present."""
        with self._lock:
            self._entries.clear()
            self._streams.clear()
            for row in seed:
                self.add(*row[:4])
            self.incremental_updates = 0

    def resize(self, buckets: int) -> None:
        """Re-bucket the whole digest under a new bucket count (the
        light-client knob change): the stored per-entry key byte makes
        this a pure table rebuild — no caller rescan.  Peer-sync
        digests never resize (both sides must bucket identically);
        only the subscription plane's private digest does."""
        if buckets < 1:
            raise ValueError("bucket count must be >= 1")
        with self._lock:
            self.buckets = buckets
            self._streams.clear()
            for hash_, (stream, _, sid, kw) in self._entries.items():
                counts, xors = self._tables(stream)
                b = kw % buckets
                counts[b] += 1
                xors[b] ^= sid
            self.incremental_updates += 1

    # -- queries -------------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, hash_: bytes) -> bool:
        with self._lock:
            return hash_ in self._entries

    def summaries(self, stream: int) -> list[tuple[int, int]]:
        """``(count, xor)`` per bucket for one stream."""
        with self._lock:
            counts, xors = self._tables(stream)
            return list(zip(counts, xors))

    def mismatched_buckets(self, stream: int,
                           remote: list[tuple[int, int]]) -> list[int]:
        """Bucket indices whose summaries differ from a peer's.  A
        remote summary with a different bucket count is entirely
        incomparable — every bucket mismatches."""
        with self._lock:
            local = self.summaries(stream)
            if len(remote) != len(local):
                return list(range(self.buckets))
            return [i for i, (mine, theirs) in
                    enumerate(zip(local, remote)) if mine != theirs]

    def hashes_in_buckets(self, stream: int,
                          buckets: "set[int] | list[int]") -> list[bytes]:
        wanted = set(buckets)
        with self._lock:
            return [h for h, (s, _, _, kw) in self._entries.items()
                    if s == stream and kw % self.buckets in wanted]

    def hashes_by_stream(self, stream: int) -> list[bytes]:
        with self._lock:
            return [h for h, (s, _, _, _) in self._entries.items()
                    if s == stream]
