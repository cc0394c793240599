"""Object-keyed negative cache in front of trial decryption (copy of
``pybitmessage_tpu.crypto.screen``, with plain counters for its
metrics).

Every keyring-holding node trial-decrypts every object against every
local key, and the common case by far is "matches none of them": gossip
re-floods the same objects, and every re-arrival would pay the full
ECDH sweep again.  This screen remembers proven no-match objects so a
re-arrival skips the scalar multiplications entirely.

Correctness rules, enforced here and at the call sites
(``workers/cryptopool.py``, ``crypto/batch.py``):

- **Keyed by object tag + keyring epoch.**  Any identity or
  subscription add/remove bumps the epoch (KeyStore change listeners)
  and flushes the table.
- **Insert only on genuinely completed sweeps.**  The batch engine's
  conservative settlements (drain failure, shutdown) never insert, and
  :meth:`insert` drops writes whose sweep began under an older epoch.
- **Bounded.**  LRU over ``capacity`` entries.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

from ..observability import REGISTRY

#: default table size — 64k proofs cover multiple TTL windows of a
#: busy stream's distinct objects at 32 bytes of key each
DEFAULT_CAPACITY = 65536

SCREEN_HITS = REGISTRY.counter(
    "crypto_screen_hits_total",
    "Trial-decrypt sweeps skipped entirely because the object is a "
    "cached no-match for the current keyring epoch")
SCREEN_MISSES = REGISTRY.counter(
    "crypto_screen_misses_total",
    "Trial-decrypt screen probes that found no entry (the sweep runs; "
    "a completed no-match sweep then populates the screen)")
SCREEN_INVALIDATIONS = REGISTRY.counter(
    "crypto_screen_invalidations_total",
    "Keyring-epoch bumps (identity/subscription add or remove) that "
    "flushed every cached no-match proof")


class NegativeScreen:
    """Bounded LRU of proven no-match object tags for one keyring epoch.

    Thread-safe: probed from the event loop, populated from the batch
    engine's dispatch thread, and bumped from whichever thread mutates
    the keystore.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = max(1, capacity)
        self.epoch = 0
        self._lock = threading.Lock()
        self._entries: OrderedDict[bytes, None] = OrderedDict()
        #: probes that skipped a sweep / found no entry, and epoch bumps
        self.hits = 0
        self.misses = 0
        self.invalidations = 0

    def __len__(self) -> int:
        return len(self._entries)

    def bump(self) -> None:
        """Keyring changed: new epoch, every cached proof is void."""
        with self._lock:
            self.epoch += 1
            self._entries.clear()
            self.invalidations += 1
        SCREEN_INVALIDATIONS.inc()

    def check(self, tag: bytes) -> bool:
        """True when ``tag`` is a cached no-match for the CURRENT
        epoch (the sweep may be skipped); counts the probe either way
        and refreshes a hit's LRU position."""
        with self._lock:
            hit = tag in self._entries
            if hit:
                self._entries.move_to_end(tag)
                self.hits += 1
            else:
                self.misses += 1
        (SCREEN_HITS if hit else SCREEN_MISSES).inc()
        return hit

    def insert(self, tag: bytes, epoch: int) -> bool:
        """Record a GENUINELY completed no-match sweep that started at
        keyring ``epoch``.  Dropped (returns False) when the keyring
        has moved since — the sweep did not cover the new key set."""
        with self._lock:
            if epoch != self.epoch:
                return False
            self._entries[tag] = None
            self._entries.move_to_end(tag)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
        return True
