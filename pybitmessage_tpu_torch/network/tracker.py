"""Object download/upload bookkeeping (copy of
``pybitmessage_tpu.network.tracker``).

Per-connection state (reference: src/network/objectracker.py):
``objects_new_to_me`` — inv hashes the peer advertised that we lack
(RandomTrackingDict so request order is anonymized);
``objects_new_to_them`` — hashes we should advertise to the peer.
Global state: ``missing`` — hashes requested anywhere, with timestamps,
so two connections don't download the same object twice
(downloadthread.py:42-84).
"""

from __future__ import annotations

import random
import threading
import time

from ..utils.randomtracking import RandomTrackingDict

#: give up on a requested object after this long (downloadthread.py:16)
REQUEST_TIMEOUT = 3600
#: forget objects-new-to-them entries after this long (objectracker.py)
TRACK_TIMEOUT = 3600
#: max getdata hashes per request round (downloadthread.py:26)
MAX_REQUEST_CHUNK = 1000
#: announcement timing-decorrelation buckets (reference MultiQueue,
#: multiqueue.py:16-54: items land in a random subqueue and each 1 s
#: inv tick drains only one, so an announcement's send time carries no
#: information about when the object arrived)
ANNOUNCE_BUCKETS = 10


class GlobalTracker:
    """Cross-connection dedup of in-flight downloads.

    A request is pinned to the connection it went out on (``via``):
    when that connection closes, :meth:`release` lets another one ask
    again, and a getdata that never left is handed back with
    :meth:`forget`.  (The JAX package keeps every request for
    ``REQUEST_TIMEOUT``, so an object asked for on a connection that
    dies before it is served is not fetched again for an hour.)"""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self.missing: dict[bytes, float] = {}
        #: the connection each request went out on
        self._via: dict[bytes, object] = {}

    def mark_requested(self, hashes: list[bytes], via=None) -> None:
        now = time.time()
        with self._lock:
            for h in hashes:
                self.missing[h] = now
                if via is not None:
                    self._via[h] = via

    def was_requested(self, hash_: bytes) -> bool:
        with self._lock:
            return hash_ in self.missing

    def received(self, hash_: bytes) -> None:
        self.forget([hash_])

    def forget(self, hashes: list[bytes]) -> None:
        """Drop these requests: any connection may ask for them again."""
        with self._lock:
            for h in hashes:
                self.missing.pop(h, None)
                self._via.pop(h, None)

    def release(self, via) -> int:
        """Forget the requests that went out on ``via`` (a connection
        that closed before it delivered them); how many."""
        with self._lock:
            lost = [h for h, c in self._via.items() if c is via]
            self.forget(lost)
            return len(lost)

    def pending_count(self) -> int:
        with self._lock:
            return len(self.missing)

    def expire(self) -> int:
        cutoff = time.time() - REQUEST_TIMEOUT
        with self._lock:
            stale = [h for h, t in self.missing.items() if t < cutoff]
            self.forget(stale)
            return len(stale)


class ConnectionTracker:
    """Per-connection object view.

    ``buckets`` controls announcement timing decorrelation: pending
    announcements are assigned to a random bucket and each call to
    :meth:`take_announcements` drains only the next bucket in rotation
    (so with the pool's 1 s inv cadence an announcement leaves 0..N-1
    seconds after it was queued, uncorrelated with arrival time).
    ``buckets=1`` disables the jitter (tests).  ``rng`` draws the
    buckets and the download picks (the module's generator by default;
    the simulated mesh passes its own seeded one).
    """

    def __init__(self, buckets: int = ANNOUNCE_BUCKETS,
                 rng: random.Random | None = None) -> None:
        self._rng = rng if rng is not None else random
        self.objects_new_to_me: RandomTrackingDict[bytes, bool] = \
            RandomTrackingDict(rng)
        self.buckets = max(1, buckets)
        self._new_to_them: list[dict[bytes, float]] = [
            {} for _ in range(self.buckets)]
        self._rotation = 0
        self._lock = threading.RLock()

    def peer_announced(self, hash_: bytes) -> None:
        """Peer inv'd this hash — it knows it; maybe we want it."""
        with self._lock:
            for bucket in self._new_to_them:
                bucket.pop(hash_, None)
        self.objects_new_to_me[hash_] = True

    def we_should_announce(self, hash_: bytes) -> None:
        with self._lock:
            self._new_to_them[self._rng.randrange(self.buckets)][hash_] = \
                time.time()

    def take_announcements(self, limit: int = 50000) -> list[bytes]:
        """Drain one rotation bucket (reference invthread + MultiQueue
        iterate(), invthread.py:50-111)."""
        with self._lock:
            bucket = self._new_to_them[self._rotation]
            self._rotation = (self._rotation + 1) % self.buckets
            out = list(bucket)[:limit]
            for h in out:
                del bucket[h]
            return out

    def pending_announcements(self) -> int:
        with self._lock:
            return sum(len(b) for b in self._new_to_them)

    def object_received(self, hash_: bytes) -> None:
        self.objects_new_to_me.pop(hash_, None)

    def request_batch(self, fair_share: int) -> list[bytes]:
        return self.objects_new_to_me.random_keys(
            max(1, min(fair_share, MAX_REQUEST_CHUNK)))

    def request_failed(self, hashes: list[bytes]) -> None:
        """A getdata for ``hashes`` never went out: they are eligible
        for the next :meth:`request_batch` at once."""
        for h in hashes:
            if self.objects_new_to_me.pop(h, None) is not None:
                self.objects_new_to_me[h] = True

    def clean(self) -> None:
        cutoff = time.time() - TRACK_TIMEOUT
        with self._lock:
            for bucket in self._new_to_them:
                for h in [h for h, t in bucket.items() if t < cutoff]:
                    del bucket[h]
